"""The port's LM stack against the reference's, on the CPU: the hybrid
and SSM ``reduced()`` architectures (the MoE ones are in
``tests/test_torch_lm_stack_moe.py``, the other six in
``tests/test_torch_lm_stack.py``).  B=2, S=64;
params from the reference's ``init_params``, carried across with
``convert.lm_params_from_numpy``.  The reference runs op by op; the
checks are in ``tests/lm_parity.py`` and their bounds are stated in
``tests/test_torch_lm_stack.py``'s docstring.
"""
import pytest

import lm_parity as P

ARCHS = ["jamba-1.5-large-398b", "mamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_loss_match_reference(arch):
    P.check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_sublayer_matches_reference_teacher_forced(arch):
    P.check_sublayers(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    P.check_decode(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a in P.TF_ARCHS])
def test_port_decode_matches_teacher_forcing(arch):
    P.check_teacher_forcing(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_loss_is_near_log_vocab(arch):
    P.check_init_loss(arch)
