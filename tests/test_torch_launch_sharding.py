"""The port's logical-axis shardings against the reference's, entry by
entry, on the production meshes: the reference over ``AbstractMesh``
(16, 16) and (2, 16, 16), the port over meta-device meshes of the same
shape (``launch/mesh.py``).  Full widths, all ten architectures; plans
only, nothing is traced."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.dist import sharding as JS
from repro.launch import shapes as JSHP
from repro.models import transformer as JT
from repro.serve import step as JSTEP
from repro.train import step as JTRAIN

from repro_torch.configs import ARCHS
from repro_torch.dist import sharding as TS
from repro_torch.launch import shapes as TSHP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TT
from repro_torch.serve import step as TSTEP
from repro_torch.train import step as TTRAIN
from repro_torch.tree import leaves

MESHES = ("pod1", "pod2")


def j_mesh(which):
    if which == "pod2":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def t_mesh(which):
    return make_production_mesh(multi_pod=which == "pod2")


def j_specs(tree):
    """The spec entries of every NamedSharding leaf, in tree order."""
    return [tuple(s.spec) for s in jax.tree.leaves(tree)]


def t_specs(tree):
    out = []
    for s in leaves(tree):
        assert isinstance(s, TS.NamedSharding), s
        out.append(s.spec)
    return out


def test_production_meshes_match_the_reference():
    for which in MESHES:
        jm, tm = j_mesh(which), t_mesh(which)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape)
        assert {d.type for d in tm.devices} == {"meta"}


LOGICAL_CASES = [
    (("batch", None), (256, 1)),
    (("batch", None), (1, 1)),                 # indivisible: replicated
    (("vocab", "d_model"), (504, 1280)),       # hubert's vocab on 16
    (("vocab", "d_model"), (512, 1280)),
    (("heads", "kv"), (4096, 1024)),           # "model" used once only
    (("batch", "expert", "ff"), (512, 128, 4864)),
    (("expert", "d_model", "ff"), (128, 7168, 4864)),
    (("zero", "heads"), (64, 4096)),
    (("lists", None, "kv_head_dim"), (6144, 128, 128)),
    ((None, "ssm_head", None), (4, 128, 64)),
    (("nonexistent", "ff"), (16, 24)),
    (("batch", "seq", "state"), (32, 32768, 128)),
]


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("names,shape", LOGICAL_CASES,
                         ids=[f"{'-'.join(map(str, n))}-{s}"
                              for n, s in LOGICAL_CASES])
def test_logical_spec(which, names, shape):
    with JS.axis_rules(j_mesh(which)):
        want = tuple(JS.logical_spec(*names, shape=shape))
    with TS.axis_rules(t_mesh(which)):
        got = TS.logical_spec(*names, shape=shape)
    assert got == want
    rules = dict(JS.DEFAULT_RULES, kv_head_dim="model")
    with JS.axis_rules(j_mesh(which), rules):
        want = tuple(JS.logical_spec(*names, shape=shape))
    with TS.axis_rules(t_mesh(which), rules):
        got = TS.logical_spec(*names, shape=shape)
    assert got == want


def test_rules_and_context_state():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    assert TS.zero1_rules() == JS.zero1_rules()
    assert TS.DEFAULT_RULES is not TS.zero1_rules()
    mesh = t_mesh("pod1")
    assert TS._state.ctx is None
    with pytest.raises(AssertionError):
        TS.logical_spec("batch", shape=(16,))
    with TS.axis_rules(mesh):
        with TS.axis_rules(mesh, {"batch": "model"}):
            assert TS.logical_spec("batch", shape=(16,)) == ("model",)
        assert TS.logical_spec("batch", shape=(16,)) == ("data",)
    assert TS._state.ctx is None


def test_logical_shard_is_the_identity_and_checks_its_names():
    x = torch.empty(256, 64, device="meta")
    assert TS.logical_shard(x, "batch", "nonsense", "extra") is x
    with TS.axis_rules(t_mesh("pod1")):
        assert TS.logical_shard(x, "batch", None) is x
        with pytest.raises(IndexError):      # the reference raises too
            TS.logical_shard(x, "batch", None, "heads")
    with JS.axis_rules(j_mesh("pod1")):
        with pytest.raises(IndexError):
            JS.logical_spec("batch", None, "heads", shape=(256, 64))


def test_hubert_vocab_stays_replicated():
    specs = TT.param_specs(ARCHS["hubert-xlarge"])
    assert specs["embed"].shape[0] == 504
    sh = TS.param_shardings(specs, t_mesh("pod1"),
                            is_leaf=lambda x: isinstance(x, TT.ParamSpec))
    assert sh["embed"].spec == (None, None)
    assert sh["embed"].shards() == 1


ARCH_NAMES = list(ARCHS)


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shardings(arch, which):
    want = JS.param_shardings(JT.param_specs(J_ARCHS[arch]), j_mesh(which),
                              is_leaf=lambda x: isinstance(x, JT.ParamSpec))
    got = TS.param_shardings(TT.param_specs(ARCHS[arch]), t_mesh(which),
                             is_leaf=lambda x: isinstance(x, TT.ParamSpec))
    assert t_specs(got) == j_specs(want)
    # the zero1 rules and a logical_of override resolve alike
    want = JS.param_shardings(
        JT.param_specs(J_ARCHS[arch]), j_mesh(which), rules=JS.zero1_rules(),
        is_leaf=lambda x: isinstance(x, JT.ParamSpec),
        logical_of=lambda s: ("zero",) + tuple(s.logical[1:]))
    got = TS.param_shardings(
        TT.param_specs(ARCHS[arch]), t_mesh(which), rules=TS.zero1_rules(),
        is_leaf=lambda x: isinstance(x, TT.ParamSpec),
        logical_of=lambda s: ("zero",) + tuple(s.logical[1:]))
    assert t_specs(got) == j_specs(want)


DECODE_ARCHS = [a for a in ARCH_NAMES if ARCHS[a].has_decode]


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_shardings(arch, which):
    jc, tc = J_ARCHS[arch], ARCHS[arch]
    jm, tm = j_mesh(which), t_mesh(which)
    cases = [(JSTEP.cache_specs(jc, 128, 32768),
              TSTEP.cache_specs(tc, 128, 32768)),
             (JSTEP.cache_specs(jc, 1, 524288),
              TSTEP.cache_specs(tc, 1, 524288))]
    if tc.attn_every == 0:
        kc = dataclasses.asdict(TSHP.LONG_KNN_CFG)
        for dt in ("bf16", "int8"):
            jk = dataclasses.replace(JSHP.LONG_KNN_CFG, cache_dtype=dt)
            tk = dataclasses.replace(TSHP.LONG_KNN_CFG, cache_dtype=dt)
            assert dataclasses.asdict(jk) == dict(kc, cache_dtype=dt)
            cases.append((JSTEP.knn_decode_cache_specs(jc, jk, 1),
                          TSTEP.knn_decode_cache_specs(tc, tk, 1)))
    for jtree, ttree in cases:
        assert [tuple(x.shape) for x in leaves(ttree)] == \
            [tuple(x.shape) for x in jax.tree.leaves(jtree)]
        for long_context in (False, True):
            want = JSTEP.cache_shardings(jc, jm, jtree,
                                         long_context=long_context)
            got = TSTEP.cache_shardings(tc, tm, ttree,
                                        long_context=long_context)
            assert t_specs(got) == j_specs(want), long_context


TRAIN_CASES = [(a, False) for a in ARCH_NAMES] + [
    ("arctic-480b", True), ("jamba-1.5-large-398b", True)]


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch,fsdp", TRAIN_CASES)
def test_train_step_shardings(arch, fsdp, which):
    jc, tc = J_ARCHS[arch], ARCHS[arch]
    jb = JSHP._batch_specs(jc, 256, 4096, labels=True)
    tb = TSHP._batch_specs(tc, 256, 4096, labels=True)
    for zero1 in (True, False):
        want = JTRAIN.train_step_shardings(
            jc, j_mesh(which), JTRAIN.TrainConfig(fsdp=fsdp, zero1=zero1), jb)
        got = TTRAIN.train_step_shardings(
            tc, t_mesh(which), TTRAIN.TrainConfig(fsdp=fsdp, zero1=zero1), tb)
        assert t_specs(got) == j_specs(want), zero1
    # the batch's specs: dim 0 over the batch axes, positions3 too
    assert all(s.spec[0] in ("data", ("pod", "data"), None)
               for s in leaves(got[0][2]))


def test_batch_specs_and_shardings_match():
    for arch in ARCH_NAMES:
        for which in MESHES:
            jb = JSHP._batch_specs(J_ARCHS[arch], 32, 32768, labels=False)
            tb = TSHP._batch_specs(ARCHS[arch], 32, 32768, labels=False)
            assert sorted(tb) == sorted(jb)
            for k in jb:
                assert tuple(tb[k].shape) == jb[k].shape
                assert str(tb[k].dtype) == "torch." + str(
                    jnp.dtype(jb[k].dtype))
            assert t_specs(TSHP._batch_shardings(t_mesh(which), tb)) == \
                j_specs(JSHP._batch_shardings(j_mesh(which), jb))


def test_host_mesh_needs_a_card_unless_asked(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    for dev in ("cpu", "meta"):
        m = make_host_mesh(device=dev)
        assert m.axis_names == ("data", "model") and m.shape == {
            "data": 1, "model": 1}
        assert m.devices == (torch.device(dev),)
