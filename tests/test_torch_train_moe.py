"""The port's training gradients against the reference's, on the CPU:
the two MoE ``reduced()`` architectures (the other eight are in
``tests/test_torch_train.py`` and ``tests/test_torch_train_ssm.py``).
The reference runs op by op; the checks are in ``tests/train_parity.py``
and their bounds are stated in ``tests/test_torch_train.py``'s
docstring."""
import pytest

import train_parity as TP

ARCHS = ["arctic-480b", "olmoe-1b-7b"]


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
