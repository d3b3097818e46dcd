"""The port's training path against the JAX package on the recurrent
(mamba2-1.3b), hybrid (hymba-1.5b), audio (musicgen-medium, four
codebooks) and MoE (granite-moe-3b-a800m, llama4-scout-17b-a16e, capacity
bound in training) archs, on the CPU: the same check and tolerances as
``tests/test_torch_train.py``'s dense archs (see its docstring)."""

import pytest

from test_torch_train import MIXER_ARCHS, VARIANTS, check_loss_and_grads


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_loss_and_grads_match_jax(arch, variant):
    """Loss and every gradient leaf against
    ``jax.value_and_grad(tf.loss_fn)``, ``remat`` off and on under each
    ``remat_policy``."""
    check_loss_and_grads(arch, variant)
