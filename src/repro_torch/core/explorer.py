"""Backward-compatibility alias: the design-space search lives in
``repro_torch.search``.

``repro_torch.core.explorer`` *is* ``repro_torch.search.engine`` — this
module replaces itself in ``sys.modules`` with the engine module, so
``from repro_torch.core.explorer import explore_design_space``, reaching
into internals (``_objective``) and monkeypatching module attributes
(``explorer_mod.simulate_batch``) all hit the real engine, as with
``repro.core.explorer``.  New code should import from
``repro_torch.search`` directly.
"""
import sys

from repro_torch.search import engine as _engine

sys.modules[__name__] = _engine
