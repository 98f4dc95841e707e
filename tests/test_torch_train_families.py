"""The port's training path against the reference for the families
beyond the dense one, in float32 at smoke widths (CPU): grok-1's mixture
of experts, deepseek-v2-lite's latent attention and experts, whisper's
encoder and cross sublayers, llama-3.2-vision's gated cross layers,
mamba2's SSD layers and hymba's hybrid layers. The checks and their
tolerances are ``tests/test_torch_train.py``'s (see its docstring): the
forward, the loss and every gradient, three ``train_step``s, remat, and
for the two mixture-of-experts archs the routing of every MoE layer's
input by the port and by the reference, flips reported with their top-2
gaps."""
import pytest

pytest.importorskip("torch")

from test_torch_train import (check_forward, check_grads,  # noqa: E402
                              check_remat, check_routing, check_steps)

ARCHS = ("grok-1-314b", "deepseek-v2-lite-16b", "whisper-large-v3",
         "llama-3.2-vision-11b", "mamba2-780m", "hymba-1.5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    check_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch", ("grok-1-314b", "deepseek-v2-lite-16b"))
def test_moe_routing_matches_reference(arch, monkeypatch):
    check_routing(arch, monkeypatch)
