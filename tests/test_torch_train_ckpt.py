"""The port's checkpoints, elastic replanning and train CLI against the
reference's, on the CPU (``src/repro_torch/dist/``,
``src/repro_torch/launch/train.py``).

* Checkpoints cross between the packages both ways, bitwise: the
  port's save of ``{"params", "opt"}`` restores through
  ``repro.dist.checkpoint`` into the reference's template, and the
  reference's save through the port's (leaf ``i`` is leaf ``i`` of
  ``jax.tree.leaves``: dict keys sorted, ``OptState`` in field order);
  retention, ``latest_step`` and the leaf-count check as the
  reference's; one step, a save, a restore and one step bitwise equal
  to two straight steps.
* ``replan_mesh`` / ``rescale_batch`` equal to the reference's over a
  table of cases (the same device handles to both).
* The train CLI in a subprocess: 3 steps with a checkpoint every 2,
  then a rerun that resumes from step 2 and reads the same step-2 loss;
  without ``--device cpu`` it needs a card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro.dist import checkpoint as JCK
from repro.dist import elastic as JE
from repro.optim import adamw as JA
from repro_torch.configs import ARCHS
from repro_torch.convert import opt_state_from_numpy
from repro_torch.dist import checkpoint as CK
from repro_torch.dist import elastic as E
from repro_torch.launch import train as cli
from repro_torch.models.transformer import init_params
from repro_torch.optim import OptState, adamw_init
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]


def _state():
    """The reference's params + a non-trivial AdamW state, and the
    port's copy of both."""
    r, tr, params, tp, _ = P.setup("qwen3-8b")
    rng = np.random.default_rng(0)
    jo = JA.OptState(
        mu=jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape).astype(np.float32)), params),
        nu=jax.tree.map(lambda x: jnp.asarray(np.abs(rng.standard_normal(
            x.shape)).astype(np.float32)), params),
        step=jnp.int32(7))
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    return {"params": params, "opt": jo}, {"params": tp, "opt": to}


def _equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _state()
    d = str(tmp_path / "ck")
    path = CK.save_checkpoint(d, 7, tstate)
    assert path == os.path.join(d, "step_00000007")
    assert sorted(os.listdir(d)) == ["step_00000007"]
    assert JCK.latest_step(d) == 7
    _equal(JCK.restore_checkpoint(d, jstate), tstate)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _state()
    d = str(tmp_path / "ck")
    JCK.save_checkpoint(d, 3, jstate)
    assert CK.latest_step(d) == 3
    got = CK.restore_checkpoint(d, tstate)
    assert isinstance(got["opt"], OptState)
    assert got["opt"].step.dtype == torch.int32 and got["opt"].step.shape \
        == ()
    _equal(jstate, got)
    assert all(t.device == torch.device("cpu") for t in leaves(got))


def test_retention_latest_step_and_leaf_count(tmp_path):
    _, tstate = _state()
    d = str(tmp_path / "ck")
    assert CK.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        CK.restore_checkpoint(d, tstate)
    for s in (1, 2, 3, 4, 5):
        CK.save_checkpoint(d, s, {"p": tstate["params"]["final_norm"]},
                           keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # unpublished
    assert CK.latest_step(d) == JCK.latest_step(d) == 5
    with pytest.raises(ValueError, match="template expects"):
        CK.restore_checkpoint(d, tstate)
    with pytest.raises(TypeError, match="bfloat16"):
        CK.save_checkpoint(d, 6, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_resume_is_bitwise_two_straight_steps(tmp_path):
    r = ARCHS["qwen3-8b"].reduced()
    params = init_params(r, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    step = make_train_step(r, TrainConfig(accum=2))
    g = torch.Generator().manual_seed(1)
    b1, b2 = (cli.synthetic_lm_batch(g, r, 4, 32) for _ in range(2))
    p1, o1, _ = step(params, opt, b1)
    p2, o2, m2 = step(p1, o1, b2)
    d = str(tmp_path / "ck")
    CK.save_checkpoint(d, 1, {"params": p1, "opt": o1})
    back = CK.restore_checkpoint(d, {"params": params, "opt": opt})
    q2, r2, n2 = step(back["params"], back["opt"], b2)
    for a, b in zip(leaves((p2, o2, m2)), leaves((q2, r2, n2))):
        assert torch.equal(a, b)


DEVS = tuple(f"cuda:{i}" for i in range(8))


@pytest.mark.parametrize("model,failed", [
    (1, ()), (2, ()), (1, ("cuda:3",)), (2, ("cuda:3",)),
    (4, ("cuda:0", "cuda:1", "cuda:2")), (2, DEVS[:5]), (8, ()),
])
def test_replan_mesh_and_rescale_batch_match_reference(model, failed):
    want = JE.replan_mesh(DEVS, model=model, failed=failed)
    got = E.replan_mesh(DEVS, model=model, failed=failed)
    assert (got.data_size, got.model_size, got.devices, got.n_devices) == (
        want.data_size, want.model_size, want.devices, want.n_devices)
    for gb, accum, orig in ((256, 8, None), (256, 8, 8 // model), (4, 2, None),
                            (7, 3, 2), (1, 1, None)):
        assert E.rescale_batch(gb, accum, got, orig) == JE.rescale_batch(
            gb, accum, want, orig)


def test_replan_mesh_refuses_too_few_devices_and_takes_torch_devices():
    with pytest.raises(ValueError, match="model axis needs 4"):
        E.replan_mesh(DEVS, model=4, failed=DEVS[:5])
    devs = [torch.device("cuda", i) for i in range(4)]
    plan = E.replan_mesh(devs, model=1, failed=[torch.device("cuda", 2)])
    assert plan.devices == (devs[0], devs[1], devs[3])
    assert E.rescale_batch(256, 8, plan, orig_data_size=4) == (264, 11)


def _run(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", *argv], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def test_train_cli_runs_checkpoints_and_resumes(tmp_path):
    args = ("--arch", "qwen3-8b", "--steps", "3", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "ck"))
    first = _run(*args)
    assert [ln.split()[:2] for ln in first[:-1]] == [["step", "0"],
                                                     ["step", "2"]]
    assert first[-1] == "done"
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002"]
    second = _run(*args)
    assert second[0] == "resumed from step 2" and second[-1] == "done"
    assert second[1].split()[:4] == first[1].split()[:4]    # step 2's loss
    loss0 = float(first[0].split()[3])
    assert 3.0 < loss0 < 12.0


def test_train_cli_needs_a_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--arch", "qwen3-8b", "--steps", "1"])
    assert cli.parser().parse_args(["--arch", "qwen3-8b"]).reduced is True
