"""The port's optimizer, gradient compression and train step against the
reference's, on the CPU (``src/repro_torch/optim/``,
``src/repro_torch/train/step.py``).

Bounds, measured on these inputs first:
* ``adamw_update`` alone from identical grads, state and params (f32,
  clipping engaged and not, early and late in the schedule): new
  params, ``mu``, ``nu``, ``grad_norm`` and ``lr`` within ``rtol`` 1e-6
  (measured: bitwise but for an ulp of the norm's sum order);
  ``cosine_schedule`` over warmup, decay and past ``total_steps``
  within ``rtol`` 1e-6;
* ``compress_tree`` / ``decompress_tree`` (none / bf16 / int8, round
  half to even) bitwise the reference's; ``compressed_psum`` at one
  shard bitwise the reference's ``shard_map`` at a one-device mesh, at
  four shards equal to the reference's sum of the shards' compressed
  values (int8: the codes summed, times the largest scale);
* ``make_train_step`` at accum 1 and 2 against the reference's on the
  reduced qwen3-8b (B 1 and 2, S 64: microbatches of one sequence, so
  the reference's per-op compiles serve both; op by op with remat off,
  whose gradients are bitwise its remat on): loss within 1e-3
  relative (measured <= 5.2e-6), ``grad_norm`` within 1e-2 relative
  (measured <= 4.3e-4), ``lr`` within ``rtol`` 1e-6 (measured equal),
  ``opt.step`` equal; params only weakly (step 1's update is +-lr
  wherever |g| >> eps, so a gradient of the other sign near zero moves
  an element by 2 lr): within 2 lr, plus 1e-6 for the f32 rounding of
  the new value (measured 2.007 lr: an ulp of a norm scale of 1 is 0.04
  lr at step 1);
* the reference's own ``tests/test_dist.py`` properties, at its bounds,
  on the port: the loss falls over 8 steps; accum 1 against accum 4
  (loss ``rtol`` 2e-2, params within 5e-2); compression none / bf16 /
  int8 (params within 1e-2 / 5e-2 of none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro.dist import shard_map
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.train import step as JS
from repro_torch.configs import ARCHS
from repro_torch.convert import opt_state_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, compress_tree,
                               compressed_psum, cosine_schedule,
                               decompress_tree)
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.tree import leaves, tree_map


def _tree(rng, scale=1.0, positive=False):
    def arr(*shape):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return {"a": arr(4, 5), "b": {"c": arr(3), "d": arr(2, 3, 4)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(ref, got, rtol=1e-6):
    for a, b in zip(jax.tree.leaves(ref), leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])     # clip off / on
@pytest.mark.parametrize("step,cfg", [
    (0, AdamWConfig()),
    (3, AdamWConfig()),
    (7, AdamWConfig(warmup_steps=2, total_steps=10, weight_decay=0.05)),
])
def test_adamw_update_matches_reference(grad_scale, step, cfg):
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    mu = _tree(rng, 0.1 * (step > 0))
    nu = _tree(rng, 0.01 * (step > 0), positive=True)
    jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jo, jm = JA.adamw_update(_j(grads), JA.OptState(
        _j(mu), _j(nu), jnp.int32(step)), _j(params), jcfg)
    tp, to, tm = adamw_update(_t(grads), OptState(
        _t(mu), _t(nu), torch.tensor(step, dtype=torch.int32)), _t(params),
        cfg)
    clipped = float(jm["grad_norm"]) > cfg.clip_norm
    assert clipped == (grad_scale > 1)
    _close(jp, tp)
    _close(jo.mu, to.mu)
    _close(jo.nu, to.nu)
    assert to.step.dtype == torch.int32 and int(to.step) == step + 1
    for k in ("grad_norm", "lr"):
        assert tm[k].dtype == torch.float32 and tm[k].shape == ()
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    for cfg in (AdamWConfig(), AdamWConfig(warmup_steps=0, total_steps=5)):
        jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
        steps = [0, 1, 2, 50, 99, 100, 101, 2500, 9999, 10000, 10001, 20000]
        got = cosine_schedule(cfg, torch.tensor(steps, dtype=torch.int32))
        want = JA.cosine_schedule(jcfg, jnp.asarray(steps, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_adamw_init_and_opt_state_from_numpy():
    r = ARCHS["qwen3-8b"].reduced()
    p = init_params(r, torch.Generator().manual_seed(0), "cpu")
    o = adamw_init(p)
    assert o._fields == ("mu", "nu", "step")
    assert o.step.dtype == torch.int32 and int(o.step) == 0
    assert all(not x.any() and x.dtype == torch.float32
               for x in leaves((o.mu, o.nu)))
    assert o.mu["embed"] is not o.nu["embed"]
    jo = JA.adamw_init(jax.tree.map(jnp.asarray, tree_map(
        lambda t: t.numpy(), p)))
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    assert isinstance(to, OptState)
    assert len(leaves(to)) == len(jax.tree.leaves(jo))
    assert to.step.dtype == torch.int32


def _grad_tree(rng):
    t = _tree(rng)
    t["ties"] = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 0.0],
                         np.float32)
    t["zero"] = np.zeros(3, np.float32)
    return t


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_tree_is_bitwise_the_reference(mode):
    g = _grad_tree(np.random.default_rng(1))
    jc, js = JC.compress_tree(_j(g), mode)
    tc, ts = compress_tree(_t(g), mode)
    for a, b in zip(jax.tree.leaves(jc), leaves(tc)):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a).astype(np.float32))
    assert (js is None) == (ts is None)
    if js is not None:
        for a, b in zip(jax.tree.leaves(js), leaves(ts)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jd = JC.decompress_tree(jc, js, mode)
    td = decompress_tree(tc, ts, mode)
    for a, b in zip(jax.tree.leaves(jd), leaves(td)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if mode == "int8":        # 127 / 127 = 1: the ties round half to even
        assert tc["ties"].tolist() == [127, 2, -4, 0, 0, 2, 0]
    with pytest.raises(ValueError):
        compress_tree(_t(g), "fp8")


@pytest.mark.parametrize("mode", ["bf16", "int8", "none"])
def test_compressed_psum_one_shard_matches_reference(mode):
    tree = {"a": jnp.arange(8, dtype=jnp.float32) / 7.0,
            "b": jnp.asarray(np.random.default_rng(2).standard_normal(
                (3, 5)).astype(np.float32))}
    mesh = jax.make_mesh((1,), ("data",))
    want = jax.jit(shard_map(
        lambda x: JC.compressed_psum(x, ("data",), mode), mesh=mesh,
        in_specs=jax.sharding.PartitionSpec(),
        out_specs=jax.sharding.PartitionSpec()))(tree)
    got = compressed_psum([_t(tree)], mode)
    for a, b in zip(jax.tree.leaves(want), leaves(got)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(tree["a"]),
                               atol=1e-2)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_psum_over_four_shards(mode):
    rng = np.random.default_rng(3)
    shards = [{"a": rng.standard_normal(6).astype(np.float32) * (i + 1)}
              for i in range(4)]
    got = compressed_psum([_t(s) for s in shards], mode)["a"].numpy()
    if mode == "bf16":
        want = sum(torch.from_numpy(s["a"]).to(torch.bfloat16).float()
                   for s in shards).numpy()
    else:
        scales = [np.maximum(np.abs(s["a"]).max(), 1e-12) / np.float32(127)
                  for s in shards]
        q = [np.clip(np.round(s["a"] / sc), -127, 127).astype(np.int32)
             for s, sc in zip(shards, scales)]
        want = sum(q).astype(np.float32) * max(scales)
    np.testing.assert_array_equal(got, want)
    if mode == "bf16":
        np.testing.assert_allclose(got, sum(s["a"] for s in shards),
                                   rtol=1e-2, atol=1e-2)


_STEP = {}


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_reference(accum):
    r, tr, params, tp, nb = P.setup("qwen3-8b")
    nb = {k: v[:accum] for k, v in nb.items()}      # microbatches of 1
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jo = JA.adamw_init(params)
    with jax.disable_jit():       # remat off: the same gradients, faster
        jp, jo2, jm = JS.make_train_step(r, JS.TrainConfig(
            accum=accum, remat=False))(params, jo, jb)
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    tp2, to2, tm = make_train_step(tr, TrainConfig(accum=accum))(tp, to, tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
        float(jm["loss"]))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(to2.step) == int(jo2.step) == 1
    lr = float(jm["lr"])
    for a, b in zip(jax.tree.leaves(jp), leaves(tp2)):
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= \
            2 * lr * (1 + 1e-3) + 1e-6


def _port_setup(accum=2, **tover):
    r = ARCHS["qwen3-8b"].reduced()
    params = init_params(r, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, r.vocab, (4, 32)).astype(
        np.int32)) for k in ("tokens", "labels")}
    return params, adamw_init(params), make_train_step(
        r, TrainConfig(accum=accum, **tover)), batch


def test_train_step_decreases_loss():
    params, opt, step, batch = _port_setup()
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()
    assert int(opt.step) == 8


def test_grad_accum_equivalence():
    outs = {}
    for a in (1, 4):
        params, opt, step, batch = _port_setup(accum=a)
        p2, _, m = step(params, opt, batch)
        outs[a] = (float(m["loss"]), p2)
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=2e-2)
    assert max(float((x - y).abs().max()) for x, y in zip(
        leaves(outs[1][1]), leaves(outs[4][1]))) < 5e-2


def test_grad_compression_modes():
    base = None
    for mode in ("none", "bf16", "int8"):
        params, opt, step, batch = _port_setup(grad_compress=mode)
        p2, _, m = step(params, opt, batch)
        assert np.isfinite(float(m["loss"]))
        if mode == "none":
            base = p2
        else:
            err = max(float((x - y).abs().max())
                      for x, y in zip(leaves(base), leaves(p2)))
            assert err < (1e-2 if mode == "bf16" else 5e-2), (mode, err)


def test_microbatch_split_puts_positions3_on_axis_1():
    from repro_torch.train import split_microbatches
    b = {"tokens": torch.arange(8 * 5).reshape(8, 5),
         "positions3": torch.arange(3 * 8 * 5).reshape(3, 8, 5)}
    mb = split_microbatches(b, 4)
    assert mb["tokens"].shape == (4, 2, 5)
    assert mb["positions3"].shape == (4, 3, 2, 5)
    assert torch.equal(mb["positions3"][1], b["positions3"][:, 2:4])
    assert torch.equal(mb["tokens"][3], b["tokens"][6:])
