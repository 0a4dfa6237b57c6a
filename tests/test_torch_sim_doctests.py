"""The ``>>>`` examples of the port's simulator modules, rewritten to
``repro_torch`` (and to ``device="cpu"`` for ``simulate_batch``), run as
``tests/test_doctests.py`` runs the reference's."""
import doctest
import importlib

import pytest
from _torch_sim import port_obs_isolation

assert port_obs_isolation  # the autouse fixture, imported to apply here

# resolved via importlib: ``repro_torch.core.simulate`` the module is
# shadowed by the function of that name once the package __init__ runs
MODULES = ("repro_torch.core.simulate", "repro_torch.fpga.archs",
           "repro_torch.analysis", "repro_torch.obs",
           "repro_torch.obs.metrics", "repro_torch.obs.trace")


@pytest.mark.parametrize("name", MODULES)
def test_port_doctests(name):
    mod = importlib.import_module(name)
    results = doctest.testmod(mod, verbose=False)
    assert results.attempted > 0, f"{name} lost its >>> examples"
    assert results.failed == 0
