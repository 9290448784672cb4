"""The port's LM stack against the reference's, on the CPU: the six
dense, vision and audio ``reduced()`` architectures (the MoE, hybrid and
SSM four are in ``tests/test_torch_lm_stack_moe.py`` and
``tests/test_torch_lm_stack_ssm.py``).  B=2, S=64;
params from the reference's ``init_params``, carried across with
``convert.lm_params_from_numpy``; the checks are in
``tests/lm_parity.py``.

The reference runs op by op (``jax.disable_jit()``): each op then rounds
as written, which is what the port mirrors.  Compiled, XLA's fusion of
the scanned stack moves some f32 results by an ulp; the bf16 roundings
that follow flip, and the reference differs from its own op-by-op run by
up to 0.2 of max|logits| on the hybrid stack (a router near-tie flips one
token's experts).

Bounds (max abs error over max|ref|), each measured on this input first:
* free-running prefill: last-position logits <= 2e-2 (measured 9.7e-3
  on jamba), argmax over all B*S positions' logits equal on >= 95% of
  rows, ``train_loss`` within 1e-3 relative;
* every sublayer of every period, teacher-forced (the port's sublayer
  takes the reference's input): hidden state and cache piece (K/V or
  Mamba state) <= 5e-3 (a module bound of 1e-2, tightened);
* one ``decode_step`` from the reference's prefill cache: logits
  <= 1e-2 (measured 3.3e-3 on arctic, where one residual element rounds
  to the other bf16 neighbour), the updated cache <= 5e-3; ``len``
  bitwise.
The cache's structure (slack padding, dtypes, ``len``) is checked
exactly.  Decode against teacher-forced prefill on the port itself, for
the reference's five architectures at ``capacity_factor=8``: relative
error < 0.05 and argmax agreement > 0.9 (``tests/test_models.py``'s
bounds); ``train_loss`` at init in (3, 12).
"""
import pytest

import lm_parity as P

ARCHS = ["gemma-2b", "hubert-xlarge", "llama3-8b", "qwen2-vl-7b",
         "qwen3-1.7b", "qwen3-8b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_loss_match_reference(arch):
    P.check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_sublayer_matches_reference_teacher_forced(arch):
    P.check_sublayers(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_decode_step_matches_reference(arch):
    P.check_decode(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a in P.TF_ARCHS])
def test_port_decode_matches_teacher_forcing(arch):
    P.check_teacher_forcing(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_loss_is_near_log_vocab(arch):
    P.check_init_loss(arch)


def test_decode_writes_the_last_slot_of_a_full_cache():
    P.check_full_cache_decode()
