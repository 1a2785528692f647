"""The port's train step against the reference's for the reduced
enc-dec model (seamless-m4t-medium), as ``test_torch_train_step.py`` does
for the dense and RWKV ones, in a file of its own so that the test runner
spreads them."""
import pytest

from test_torch_train_step import track_reference


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium"])
def test_train_step_tracks_reference(arch, opt_name):
    track_reference(arch, opt_name)
