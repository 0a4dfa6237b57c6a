"""The port's Adafactor on the reference's stacked layers, in one process,
against ``repro.optim.adafactor_update`` run on the JAX package's tree.

The JAX package stacks a layer's parameters, (G, ...) in the baseline
layout and (S, Gs, ...) in the pipeline layout
(``repro.distributed.pipeline.to_pipeline_params``), and Adafactor sees
the stacks: the RMS clip over every layer at one pattern position, a
norm's (G, d) factored with its column mean over the layers, a per-layer
scalar factored across stages.  The port keeps the layers apart and names
the stacks (``convert.layer_stacks``, ``optim.adafactor.Stacks``).

Three steps on standard-normal gradients (numpy seed 0) at lr 1e-2 from
``init_params(PRNGKey(0))`` in f32, on arctic-480b-reduced (MoE experts,
the dense residual) and granite-8b-reduced with ``optimizer="adafactor"``;
llama-vision-reduced adds the X layer's scalar gate, and whisper-tiny-reduced
(pattern "X", two layers) a stack of two scalar gates, (2,) unfactored in
the baseline layout.  Parameters and every
``vr`` / ``vc`` / ``v`` must equal the reference's at
``tests/test_torch_substrate.py``'s tolerance (rtol 1e-6: the same f32 ops,
means taken in another order).  A negative control: with no stacks (each
layer its own clip and its norms unfactored, the port before the repair)
the parameters miss the reference by far more.  The sharded update (tp,
ZeRO-1, stages) is held to the same reference in
``tests/test_torch_dist_moe.py``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.distributed import pipeline as jpp  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.model import convert  # noqa: E402
from repro_torch.optim import adafactor  # noqa: E402

LR, STEPS, RTOL = 1e-2, 3, 1e-6
CASES = {"arctic": ("arctic-480b", {}),
         "granite-adafactor": ("granite-8b", {"optimizer": "adafactor"}),
         "llama-vision-adafactor": ("llama-3.2-vision-11b",
                                    {"optimizer": "adafactor"}),
         "whisper-adafactor": ("whisper-tiny", {"optimizer": "adafactor"})}


def _cfgs(arch, over):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **over),
            dataclasses.replace(configs.get_reduced(arch), **over))


def _np_tree(tree, pipeline):
    """A JAX tree as numpy, a pipeline tree's (S, Gs, ...) stacks as the
    baseline's (G, ...)."""
    tree = jax.tree.map(np.asarray, tree)
    if pipeline:
        tree = dict(tree, groups=jax.tree.map(
            lambda a: a.reshape((-1,) + a.shape[2:]), tree["groups"]))
    return tree


def _flat(tree, cfg, pipeline):
    """{port name: array} of a JAX tree shaped as the params (the params
    or their grads): each stacked leaf's row of a layer."""
    return {n: p.numpy() for n, p in convert.from_jax_params(
        _np_tree(tree, pipeline), cfg, device="cpu",
        dtype=torch.float32).named_parameters()}


def _ref_state(jstate, jparams, cfg, pipeline):
    """The reference's state as the port holds it, by parameter name."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, p in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        st = jstate["v"]
        for k in keys:
            st = st[k]
        st = {k: np.asarray(v) for k, v in st.items()}
        if keys[0] != "groups":
            name = ".".join(str(k) for k in keys)
            out[name] = st
            continue
        pos, rest = keys[1], ".".join(str(k) for k in keys[2:])
        lead = 2 if pipeline else 1
        G = int(np.prod(p.shape[:lead]))
        per_layer = p.ndim - lead
        for gi in range(G):
            s, j = divmod(gi, p.shape[1]) if pipeline else (0, gi)
            name = convert.layer_name(cfg, pos, gi, rest)
            if per_layer >= 2:                # a matrix, per layer
                row = (s, j) if pipeline else (gi,)
                out[name] = {k: v[row] for k, v in st.items()}
            elif per_layer == 1:             # a stacked vector
                out[name] = {"vr": st["vr"][(s, j) if pipeline else gi],
                             "vc": st["vc"][s] if pipeline else st["vc"]}
            elif pipeline:                   # a scalar, (S, Gs) factored
                out[name] = {"vr": st["vr"][s], "vc": st["vc"][j]}
            else:                            # a scalar, (G,) unfactored
                out[name] = {"v": st["v"][gi]}
    return out


def _run(case, pipeline, stacked=True):
    """(port params, port state, reference params, reference state) by
    name after ``STEPS`` steps."""
    arch, over = CASES[case]
    jcfg, tcfg = _cfgs(arch, over)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    if pipeline:
        jp = jpp.to_pipeline_params(jp, 1)
    tp = convert.from_jax_params(_np_tree(jp, pipeline), tcfg, device="cpu",
                                 dtype=torch.float32)
    named = dict(tp.named_parameters())
    stacks = adafactor.Stacks(tuple(
        tuple(v) for v in convert.layer_stacks(tcfg, named).values()),
        pipeline=pipeline) if stacked else None
    js, ts = joptim.adafactor_init(jp), adafactor.adafactor_init(named,
                                                                 stacks)
    update = jax.jit(lambda p, g, s: joptim.adafactor_update(p, g, s, lr=LR))
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jp)
        jp, js = update(jp, g, js)
        grads = _flat(g, tcfg, pipeline)
        adafactor.adafactor_update(
            named, {n: torch.from_numpy(v) for n, v in grads.items()}, ts,
            lr=LR, stacks=stacks)
    return ({n: p.detach().numpy() for n, p in named.items()}, ts,
            _flat(jp, tcfg, pipeline), _ref_state(js, jp, tcfg, pipeline))



@pytest.mark.parametrize("layout", ["baseline", "pipeline"])
@pytest.mark.parametrize("case", list(CASES))
def test_adafactor_equals_the_reference_on_its_stacks(case, layout):
    got, state, want, want_state = _run(case, layout == "pipeline")
    assert int(state["step"]) == STEPS
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=RTOL, atol=1e-7,
                                   err_msg=n)
        st = state["v"][n]
        assert set(st) == set(want_state[n]), n
        for k, v in want_state[n].items():
            np.testing.assert_allclose(st[k].numpy(), v, rtol=RTOL, atol=0,
                                       err_msg=f"{n} {k}")


def test_per_layer_adafactor_misses_the_reference():
    """The port before the repair, a clip per layer and its norms
    unfactored: off by about lr on the norms (9.9e-3 of lr 1e-2 on
    arctic-reduced in one step), far past the tolerance above."""
    got, _, want, _ = _run("arctic", False, stacked=False)
    worst = {n: float(np.abs(got[n] - w).max()) for n, w in want.items()}
    assert max(worst[n] for n in worst if n.endswith("ln_mlp.w")) > 1e-3
    assert max(worst.values()) > 1e3 * RTOL
