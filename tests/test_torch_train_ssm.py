"""The port's training gradients against the reference's, on the CPU:
the hybrid and SSM ``reduced()`` architectures (the other eight are in
``tests/test_torch_train.py`` and ``tests/test_torch_train_moe.py``).
Jamba's whole-model gradients are not held (a router near-tie flips one
token's experts): its loss is, and every sublayer's VJP teacher-forced.
The reference runs op by op; the checks are in
``tests/train_parity.py`` and their bounds are stated in
``tests/test_torch_train.py``'s docstring."""
import pytest

import train_parity as TP

ARCHS = ["jamba-1.5-large-398b", "mamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_leaf_gradient_match_reference(arch):
    if arch in TP.ROUTER_TIE_ARCHS:
        TP.check_loss_only(arch)
    else:
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
