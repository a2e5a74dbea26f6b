"""The port's twin of ``tests/test_train_convergence.py`` (marked slow as
that test is): the golden scene trained for 120 ``adam_onecycle`` steps on
the plain versions must lower the loss (the mean of the last 5 losses below
half the mean of the first 5) and detect the scene's boxes (recall >= 0.5
by centre distance < 2 m at score > 0.1). The loop and the assertions are
``mssvt_tpu_torch.runtime.convergence``'s, which ``chip_smoke.py`` runs on
the card. Its step is ``runtime.train_utils.train_step``, whose multi-step
parity with JAX's step ``tests/test_torch_train.py`` holds."""

import pytest
import torch

from mssvt_tpu_torch.runtime import convergence

torch.set_num_threads(2)


@pytest.mark.slow
def test_loss_decreases_and_golden_scene_recall():
    result = convergence.train_golden("cpu")
    assert len(result["losses"]) == convergence.STEPS
    convergence.gate(result)
