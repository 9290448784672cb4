"""The port's RAIRS-kNN paged attention (``models/retrieval.py``), its
long-context decode step, the serving steps' specs
(``serve/step.py``) and the LM converters, against the reference on the
CPU.  Inputs come from numpy with a seed; keys carry the topic structure
of ``examples/long_context_retrieval.py``.

Bounds: integers and masks bitwise (the probed lists, the packed
``table``, ``key_valid``, the ring position); packed K/V blocks bitwise
(bf16 of the same f32 keys); the port's k-means from the reference's
initial rows within rtol=atol=1e-5; attention outputs (bf16 and int8
caches) <= 1e-3 of max|ref| (a module bound of 1e-2, tightened); the
long decode step's logits <= 1e-2 of max|ref| and its window rows
<= 5e-3 (one token's step: a bf16 rounding may flip upstream).  Specs:
shapes and dtypes equal to the reference's ``ShapeDtypeStruct``s for the
reduced and full configs of all ten architectures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import retrieval as JR
from repro.models import transformer as JT
from repro.serve import step as JS
from repro_torch.configs import ARCHS
from repro_torch.convert import (knn_cache_from_numpy, lm_params_from_numpy)
from repro_torch.core.kmeans import kmeans_loop
from repro_torch.models import retrieval as TR
from repro_torch.models import transformer as TT
from repro_torch.models.mamba2 import MambaState
from repro_torch.serve import step as TS

F32 = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = 1e-3
KCFG = dict(nlist=16, nprobe=4, block=16, max_blocks_per_list=8, window=32)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rel_err(ref, got):
    ref, got = f32(ref), f32(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def topic_keys(seed, b, s, kvh, hd, n_topics=8, burst=32, hot=0):
    """Bursty topics along the sequence plus noise; the first ``hot``
    keys sit tightly around one point (a list fuller than maxb)."""
    r = np.random.default_rng(seed)
    topics = r.standard_normal((n_topics, kvh, hd)).astype(np.float32)
    keys = np.stack([topics[(np.arange(s) // burst + i) % n_topics]
                     for i in range(b)])
    keys = keys + 0.3 * r.standard_normal(keys.shape).astype(np.float32)
    keys[:, :hot] = keys[:, :1] + 0.01 * r.standard_normal(
        keys[:, :hot].shape).astype(np.float32)
    vals = r.standard_normal((b, s, kvh, hd)).astype(np.float32)
    return keys.astype(np.float32), vals


def kcfgs(**kw):
    c = dict(KCFG, **kw)
    return JR.KnnAttnConfig(**c), TR.KnnAttnConfig(**c)


_REF = {}


def ref_cache(seed=0, b=2, s=512, kvh=2, hd=16, **kw):
    key = (seed, b, s, kvh, hd, tuple(sorted(kw.items())))
    if key not in _REF:
        keys, vals = topic_keys(seed, b, s, kvh, hd, hot=192)
        jk, tk = kcfgs(**kw)
        _REF[key] = (keys, vals, jk, tk,
                     JR.build_knn_cache(keys, vals, jk, seed=seed))
    return _REF[key]


def host(cache):
    return jax.tree.map(np.asarray, cache)


# ----------------------------------------------------------------------------
# building the cache
# ----------------------------------------------------------------------------
def test_pack_from_reference_centroids_is_bitwise():
    keys, vals, jk, tk, jc = ref_cache()
    tc, stats = TR.pack_knn_cache(torch.from_numpy(keys),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(np.array(jc["centroids"])),
                                  tk)
    for name in ("table", "key_valid", "k_blocks", "v_blocks", "centroids",
                 "win_k", "win_v"):
        want = np.asarray(jc[name])
        got = tc[name]
        assert tuple(got.shape) == want.shape, name
        if got.dtype == torch.bfloat16:
            assert want.dtype == jnp.bfloat16
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        np.testing.assert_array_equal(got.numpy() if isinstance(
            got, torch.Tensor) else got, want, err_msg=name)
    table = np.asarray(jc["table"])
    assert stats.nb_cap == 16 * 8 // 2
    assert list(stats.blocks) == [int(table[i, g].max()) + 1
                                  for i in range(2) for g in range(2)]
    assert sum(stats.dropped) > 0                  # full lists drop entries


def test_port_kmeans_from_reference_initial_rows():
    keys, _, jk, _, jc = ref_cache()
    for bi in range(2):
        for g in range(2):
            kk = keys[bi, :, g]
            init = np.asarray(jax.random.permutation(
                jax.random.PRNGKey(0 + 7 * g), kk.shape[0]))[:jk.nlist]
            c = kmeans_loop(torch.from_numpy(kk), torch.from_numpy(kk[init]),
                            8)
            np.testing.assert_allclose(c.numpy(),
                                       np.asarray(jc["centroids"])[bi, g],
                                       **F32)


def test_build_knn_cache_full_probe_equals_exact_attention():
    """The reference's invariant, on the port alone: with nprobe == nlist
    and no entry dropped, kNN attention is exact attention."""
    keys, vals = topic_keys(3, 1, 256, 2, 16)
    _, tk = kcfgs(nlist=8, nprobe=8, max_blocks_per_list=32, window=16)
    cache, stats = TR.build_knn_cache(torch.from_numpy(keys),
                                      torch.from_numpy(vals), tk, seed=0)
    assert sum(stats.dropped) == 0
    q = np.random.default_rng(4).standard_normal((1, 1, 4, 16)).astype(
        np.float32)
    out = TR.rairs_attention_decode(torch.from_numpy(q), cache,
                                    torch.tensor([256], dtype=torch.int32),
                                    tk)
    qg = q[:, 0].reshape(1, 2, 2, 16)
    sc = np.einsum("bgrd,bsgd->bgrs", qg / np.sqrt(16), keys)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bgrs,bsgd->bgrd", p, vals).reshape(1, 1, 4, 16)
    assert np.abs(f32(out) - ref).max() / np.abs(ref).max() < 0.05


def test_nb_cap_overflow_raises_like_the_reference():
    keys, vals = topic_keys(5, 1, 512, 1, 16)
    jk, tk = kcfgs(nlist=8, max_blocks_per_list=2)     # nb_cap = 8 blocks
    with pytest.raises(IndexError):
        JR.build_knn_cache(keys, vals, jk)
    with pytest.raises(IndexError, match="nb_cap = 8"):
        TR.build_knn_cache(torch.from_numpy(keys), torch.from_numpy(vals),
                           tk)


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def test_probe_lists_are_bitwise_with_ties():
    r = np.random.default_rng(6)
    cents = r.standard_normal((2, 2, 16, 16)).astype(np.float32)
    cents[:, :, 9] = cents[:, :, 3]                  # tied scores: 3 first
    cents[:, :, 12] = cents[:, :, 3]
    qg = r.standard_normal((2, 2, 2, 16)).astype(np.float32)
    with jax.disable_jit():
        qm = jnp.asarray(qg).mean(axis=2)
        cs = jnp.einsum("bgd,bgld->bgl", qm, jnp.asarray(cents),
                        preferred_element_type=jnp.float32)
        _, want = jax.lax.top_k(cs, 16)
    got = TR.probe_lists(torch.from_numpy(qg), torch.from_numpy(cents), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_len", [[512, 20], [33, 1]])
def test_rairs_attention_decode_bf16(kv_len):
    keys, vals, jk, tk, jc = ref_cache()
    q = np.random.default_rng(7).standard_normal((2, 1, 4, 16)).astype(
        np.float32)
    kvl = np.array(kv_len, np.int32)
    win = np.random.default_rng(8).standard_normal((2, 32, 2, 16))
    jc = dict(jc, win_k=jnp.asarray(win, jnp.bfloat16),
              win_v=jnp.asarray(-win, jnp.bfloat16))
    with jax.disable_jit():
        want = JR.rairs_attention_decode(jnp.asarray(q), jc,
                                         jnp.asarray(kvl), jk)
    got = TR.rairs_attention_decode(torch.from_numpy(q),
                                    knn_cache_from_numpy(host(jc), "cpu"),
                                    torch.from_numpy(kvl), tk)
    assert got.dtype == torch.float32
    assert rel_err(want, got) <= ATTN_TOL


def test_rairs_attention_decode_int8_scales():
    keys, vals, jk, tk, jc = ref_cache()
    kb = np.asarray(jc["k_blocks"]).astype(np.float32)
    vb = np.asarray(jc["v_blocks"]).astype(np.float32)
    ks = np.maximum(np.abs(kb).max((-1, -2)), 1e-6) / 127.0
    vs = np.maximum(np.abs(vb).max((-1, -2)), 1e-6) / 127.0
    jc8 = dict(jc,
               k_blocks=jnp.asarray(np.round(kb / ks[..., None, None])
                                    .astype(np.int8)),
               v_blocks=jnp.asarray(np.round(vb / vs[..., None, None])
                                    .astype(np.int8)),
               k_scale=jnp.asarray(ks.astype(np.float32)),
               v_scale=jnp.asarray(vs.astype(np.float32)))
    jk8, tk8 = kcfgs(cache_dtype="int8")
    q = np.random.default_rng(9).standard_normal((2, 1, 4, 16)).astype(
        np.float32)
    kvl = np.array([512, 512], np.int32)
    with jax.disable_jit():
        want = JR.rairs_attention_decode(jnp.asarray(q), jc8,
                                         jnp.asarray(kvl), jk8)
    tc8 = knn_cache_from_numpy(host(jc8), "cpu")
    assert tc8["k_blocks"].dtype == torch.int8
    got = TR.rairs_attention_decode(torch.from_numpy(q), tc8,
                                    torch.from_numpy(kvl), tk8)
    assert rel_err(want, got) <= ATTN_TOL


def test_update_window_wraps_the_ring():
    keys, vals, jk, tk, jc = ref_cache()
    r = np.random.default_rng(10)
    tc = knn_cache_from_numpy(host(jc), "cpu")
    jcur = jc
    for kv_len in ([31, 32], [32, 65], [97, 0]):     # across the wrap
        kn = r.standard_normal((2, 1, 2, 16)).astype(np.float32)
        vn = r.standard_normal((2, 1, 2, 16)).astype(np.float32)
        kvl = np.array(kv_len, np.int32)
        jcur = JR.update_window(jcur, jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(kvl))
        tc = TR.update_window(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                              torch.from_numpy(kvl))
        for name in ("win_k", "win_v"):
            np.testing.assert_array_equal(f32(tc[name]), f32(jcur[name]))


def _stack(slots):
    return jax.tree.map(lambda *a: np.stack(a), *slots)


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-1.5-large-398b"])
def test_decode_step_long_matches_reference(arch):
    r = J_ARCHS[arch].reduced()
    tr = ARCHS[arch].reduced()
    params = JT.init_params(jax.random.PRNGKey(1), r)
    tp = lm_params_from_numpy(host(params), "cpu")
    jk, tk = kcfgs(nlist=8, nprobe=3, max_blocks_per_list=12, window=16)
    s = 128
    blocks = {}
    for j, (mixer, _) in enumerate(r.slot_kinds()):
        if mixer == "attn":
            per = [host(JR.build_knn_cache(
                *topic_keys(11 + p, 2, s, r.n_kv_heads, r.hd), jk, seed=p))
                for p in range(r.n_periods)]
            blocks[f"s{j}"] = _stack(per)
        else:
            rr = np.random.default_rng(12 + j)
            c = r.ssm_heads * r.ssm_head_dim + 2 * r.ssm_state
            blocks[f"s{j}"] = (
                rr.standard_normal((r.n_periods, 2, r.ssm_heads,
                                    r.ssm_head_dim, r.ssm_state)
                                   ).astype(np.float32),
                rr.standard_normal((r.n_periods, 2, 3, c)).astype(np.float32))
    cache = {"blocks": blocks, "len": np.array([s, s + 40], np.int32)}
    tok = np.array([[5], [77]], np.int32)
    jcache = jax.tree.map(jnp.asarray, cache)
    jcache["blocks"] = {k: (v if isinstance(v, dict) else JT.MambaState(*v))
                        for k, v in jcache["blocks"].items()}
    with jax.disable_jit():
        want, wnew = JR.decode_step_long(params, r, jcache, jnp.asarray(tok),
                                         jk)
    tcache = knn_cache_from_numpy(cache, "cpu")
    assert isinstance(tcache["len"], torch.Tensor)
    got, tnew = TS.make_long_decode_step(tr, tk)(tp, tcache,
                                                 torch.from_numpy(tok))
    assert rel_err(want, got) <= 1e-2
    assert torch.equal(tnew["len"], torch.from_numpy(np.array(
        wnew["len"])))
    for name, slot in wnew["blocks"].items():
        if isinstance(slot, dict):
            for k in ("win_k", "win_v"):
                assert rel_err(slot[k], tnew["blocks"][name][k]) <= 5e-3
                np.testing.assert_array_equal(           # only one row moved
                    f32(slot[k]) != f32(jcache["blocks"][name][k]),
                    f32(tnew["blocks"][name][k]) != f32(
                        jcache["blocks"][name][k]))
        else:
            assert isinstance(tnew["blocks"][name], MambaState)
            for a, b in zip(slot, tnew["blocks"][name]):
                assert rel_err(a, b) <= 5e-3


# ----------------------------------------------------------------------------
# specs, steps, converters
# ----------------------------------------------------------------------------
def _same_specs(want, got):
    wl, wdef = jax.tree.flatten(want)
    gl = jax.tree.leaves(jax.tree.map(
        lambda t: t, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), (g, w)


def _spec_dict(tree):
    """The reference's spec tree with MambaState as a plain pair."""
    if isinstance(tree, dict):
        return {k: _spec_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_spec_dict(v) for v in tree)
    return tree


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_reference(arch, full):
    r = J_ARCHS[arch] if full else J_ARCHS[arch].reduced()
    tr = ARCHS[arch] if full else ARCHS[arch].reduced()
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        _same_specs(JT.abstract_params(r, dt), TT.abstract_params(tr, tdt))
    assert jax.tree.leaves(JT.param_logical(r), is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree.leaves(TT.param_logical(tr),
                                      is_leaf=lambda x: isinstance(x, tuple))
    _same_specs(_spec_dict(JS.cache_specs(r, 4, 128)),
                _spec_dict(TS.cache_specs(tr, 4, 128)))
    kw = dict(nlist=64, max_blocks_per_list=8, window=32)
    for dtype in ("bf16", "int8"):
        jk = JR.KnnAttnConfig(cache_dtype=dtype, **kw)
        tk = TR.KnnAttnConfig(cache_dtype=dtype, **kw)
        _same_specs(_spec_dict(JS.knn_decode_cache_specs(r, jk, 1)),
                    _spec_dict(TS.knn_decode_cache_specs(tr, tk, 1)))


def test_serving_params_and_steps():
    arch = "qwen2-vl-7b"
    r, tr = J_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    params = host(JT.init_params(jax.random.PRNGKey(2), r))
    f = lm_params_from_numpy(params, "cpu")
    h = lm_params_from_numpy(params, "cpu", serve_dtype=torch.bfloat16)
    casts = []
    TT.tree_map(lambda p, t: casts.append((p[-1], t.dtype)), h)
    assert {k for k, d in casts if d == torch.bfloat16} == (
        {k for k, _ in casts} & TT.SERVE_CAST)
    assert all(d == torch.float32 for k, d in casts
               if k not in TT.SERVE_CAST)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, r.vocab, (2, 16))
                                        .astype(np.int32)),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (2, 4, r.patch_dim)).astype(np.float32)),
             "positions3": torch.arange(16, dtype=torch.int32)[None, None]
             .expand(3, 2, 16)}
    lf, cf = TS.make_prefill_step(tr, cache_slack=1)(f, batch)
    lh, ch = TT.Model(tr, h).prefill(batch, cache_slack=1)
    assert torch.equal(lf, lh)                       # same bf16 operands
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    df, _ = TS.make_decode_step(tr)(f, cf, tok)
    dh, _ = TT.Model(tr, h).decode(ch, tok)
    assert torch.equal(df, dh)
    model = TT.Model(tr)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "tree.blocks.s0.attn.wq" in names and len(names) == len(casts)
    assert all(not t.requires_grad for t in model.parameters())
    assert torch.equal(model.params()["embed"], p["embed"])
    assert 3.0 < float(model.loss(dict(batch, labels=batch["tokens"]))) < 12.0


def test_bf16_arrays_cross_bit_for_bit():
    a = jnp.asarray(np.random.default_rng(4).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = knn_cache_from_numpy({"x": np.asarray(a)}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
    assert dataclasses.asdict(TR.KnnAttnConfig()) == dataclasses.asdict(
        JR.KnnAttnConfig())


def test_lm_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = ARCHS["qwen3-8b"].reduced()
    for call in (lambda: TT.init_params(r, torch.Generator()),
                 lambda: TT.Model(r).init(torch.Generator()),
                 lambda: lm_params_from_numpy({"x": np.zeros(2)}),
                 lambda: knn_cache_from_numpy({"x": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert TT.init_params(r, torch.Generator(), "cpu")["embed"].device.type \
        == "cpu"
