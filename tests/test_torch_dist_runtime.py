"""The port's distributed step builders (``repro_torch.launch.steps``) on
a 4-rank gloo group of CPU processes against the JAX package on one
device: granite-8b-reduced through the baseline (data 2 x model 2; pod 2 x data
2) and the floorplanned pipeline (2 stages x tp 2, boundary depth 2), sharded
serving (data 2 x model 2), and the refusals that wait for ROADMAP item
8c.

One group plays every run (``tests/_torch_dist.py``); the JAX package's
``lm.init_params(PRNGKey(0))`` weights are carried across by
``convert.from_jax_params``.  Bounds, each with its reason:
  * bf16 against the JAX package's ``loss_fn`` averaged over the
    microbatches and its ``jax.grad``: loss within 1e-3 and every
    gradient entry within 5e-3, the bounds of the JAX package's own
    pipeline test (``tests/test_distributed.py``); then one step (clip to
    norm 1, AdamW at 3e-4) against the JAX step: the grad norm within 1 %,
    and every parameter within 2 lr + 2^-7 of its value (AdamW's first
    update moves an entry by at most lr (1 + wd |p|) either way, so two
    gradients whose sign differs on an entry land at most 2 lr apart,
    plus one bf16 rounding of the parameter);
  * f32 against the port's own single-process run (``lm.loss_fn`` per
    microbatch, averaged, then ``clip_by_global_norm`` and
    ``adamw_update``): loss within 1e-5 and each gradient within 1e-4 of
    its largest entry (the same f32 arithmetic summed in other orders
    over the shards), the grad norm within 1e-5 relative, and every
    parameter after the step within the bound those two give an AdamW
    first step, entry by entry (``_torch_dist.assert_first_step``: far
    below lr where the gradient stands clear of its tolerance, 2 lr
    where its sign is in doubt), both of the one-process step and of
    the step written out from the start;
  * serving: logits teacher-forced against the JAX package's jitted
    ``lm.step``, atol 2e-2 (``tests/test_torch_model.py``'s bound).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402
import _torch_dist  # noqa: E402

ARCH = "granite-8b"
N_MICRO, MB, SEQ = 4, 2, 16
LR = 3e-4
BF16 = dict(loss=1e-3, grad=5e-3)
F32 = dict(loss=1e-5, grad_rel=1e-4, norm_rel=1e-5)
PIPE_PLAN = dict(mode="tapa", n_stages=2, groups_per_stage=1,
                 stage_slots=[(0, 0), (0, 1)], boundary_depth=[2], tp=2,
                 crossing_cost=0.0)
#: run name -> (mode, mesh, dtype); the pipeline's (data 1, model 4) mesh
#: becomes (stage 2, data 1, tp 2) under PIPE_PLAN; a 3-D mesh is (pod,
#: data, model), its data axes flattened into one group of 4
TRAIN = {"baseline-bf16": ("baseline", (2, 2), "bf16"),
         "pipeline-bf16": ("tapa", (1, 4), "bf16"),
         "baseline-f32": ("baseline", (2, 2), "f32"),
         "pipeline-f32": ("tapa", (1, 4), "f32"),
         "baseline-pod-f32": ("baseline", (2, 2, 1), "f32")}
LAYOUT = {"baseline-bf16": {"stage": 1, "data": 2, "tp": 2},
          "pipeline-bf16": {"stage": 2, "data": 1, "tp": 2},
          "baseline-f32": {"stage": 1, "data": 2, "tp": 2},
          "pipeline-f32": {"stage": 2, "data": 1, "tp": 2},
          "baseline-pod-f32": {"stage": 1, "data": 4, "tp": 1}}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
SERVE_B, PROMPT, STEPS = 4, 8, 4
SERVE_ATOL = 2e-2
REFUSE = {
    "zamba2 M layers over tp 2": dict(arch="zamba2-7b", mesh=(2, 2),
                                      builder="train"),
    "Adafactor over data 2": dict(arch=ARCH, mesh=(2, 2), builder="train",
                                  overrides={"optimizer": "adafactor"}),
    "arctic's experts over tp 2": dict(arch="arctic-480b", mesh=(2, 2),
                                       builder="train"),
    "a context-parallel KV cache": dict(arch=ARCH, mesh=(2, 2),
                                        builder="serve", kv_shard="context",
                                        cell="prefill"),
}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _by_name(tree, cfg):
    """A JAX tree (params or grads) as the port's {name: f32 array}."""
    return {n: p.numpy() for n, p in convert.from_jax_params(
        _np(tree), cfg, device="cpu",
        dtype=torch.float32).named_parameters()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX references, and every run's result from one group."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (N_MICRO, MB, SEQ + 1), 0, jcfg.vocab),
        np.int32)
    trees = {"bf16": params,
             "f32": jax.tree.map(lambda a: a.astype(jnp.float32), params)}
    runs = []
    for name, (mode, mesh, dtype) in TRAIN.items():
        runs.append(dict(kind="train", arch=ARCH, tree=_np(trees[dtype]),
                         dtype=dtype, mode=mode, mesh=mesh,
                         axes=AXES[len(mesh)], plan=PIPE_PLAN,
                         n_micro=N_MICRO,
                         tokens=tokens if mode == "tapa"
                         else tokens.reshape(N_MICRO * MB, SEQ + 1)))
    serve_toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (SERVE_B, PROMPT + STEPS), dtype=np.int32)
    feeds = [serve_toks[:, :PROMPT]] + [
        serve_toks[:, PROMPT + i:PROMPT + i + 1] for i in range(STEPS)]
    runs.append(dict(kind="serve", arch=ARCH, tree=_np(params), mesh=(2, 2),
                     feeds=feeds, max_seq=PROMPT + STEPS + 1))
    runs.append(dict(kind="refuse", cases=[
        dict(case, tree=None) for case in REFUSE.values()]))
    got = _torch_dist.launch(tmp_path_factory.mktemp("dist_runtime"), runs)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, trees=trees,
                tokens=tokens, feeds=feeds,
                runs=dict(zip(list(TRAIN) + ["serve", "refuse"], got)))


def _jax_reference(setup, dtype):
    """The JAX package's loss and grads of the microbatch average, then
    its step: (loss, grads by name, grad norm, params after by name)."""
    jcfg, tokens = setup["jcfg"], setup["tokens"]
    params = setup["trees"][dtype]

    def loss(p):
        return sum(jlm.loss_fn(p, jcfg, {"tokens": tokens[m]})
                   for m in range(N_MICRO)) / N_MICRO

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    clipped, gn = joptim.clip_by_global_norm(
        jax.tree.map(lambda g: g.astype(jnp.float32), grads), 1.0)
    after, _ = joptim.adamw_update(params, clipped,
                                   joptim.adamw_init(params), lr=LR)
    tcfg = setup["tcfg"]
    return (float(value), _by_name(grads, tcfg), float(gn),
            _by_name(after, tcfg))


def _port_reference(setup):
    """The port's single-process f32 run: (loss, grads, norm, params
    after the step) by name."""
    tcfg = setup["tcfg"]
    params = convert.from_jax_params(_np(setup["trees"]["f32"]), tcfg,
                                     device="cpu", dtype=torch.float32)
    params.requires_grad_(True)
    total = 0.0
    for m in range(N_MICRO):
        loss = lm.loss_fn(params, tcfg, {"tokens": torch.tensor(
            setup["tokens"][m])}) / N_MICRO
        loss.backward()
        total += float(loss.detach())
    named = dict(params.named_parameters())
    grads = {n: p.grad for n, p in named.items()}
    clipped, gn = optim.clip_by_global_norm(grads, 1.0)
    optim.adamw_update(named, clipped, optim.adamw_init(named), lr=LR)
    return (total, {n: g.numpy().copy() for n, g in grads.items()},
            float(gn), {n: p.detach().numpy() for n, p in named.items()})


@pytest.fixture(scope="module")
def jax_refs(setup):
    return {d: _jax_reference(setup, d) for d in ("bf16",)}


@pytest.fixture(scope="module")
def port_ref(setup):
    return _port_reference(setup)


@pytest.mark.parametrize("run", list(TRAIN))
def test_run_lays_out_the_mesh(setup, run):
    assert setup["runs"][run]["layout"] == LAYOUT[run]


@pytest.mark.parametrize("run", ["baseline-bf16", "pipeline-bf16"])
def test_loss_and_grads_match_jax(setup, jax_refs, run):
    loss, grads, _, _ = jax_refs["bf16"]
    got = setup["runs"][run]
    assert abs(got["loss"] - loss) < BF16["loss"], (got["loss"], loss)
    assert got["grads"].keys() == grads.keys()
    err = {n: float(np.abs(got["grads"][n] - g).max())
           for n, g in grads.items()}
    assert max(err.values()) < BF16["grad"], err


@pytest.mark.parametrize("run", ["baseline-bf16", "pipeline-bf16"])
def test_step_matches_jax_step(setup, jax_refs, run):
    _, _, gn, after = jax_refs["bf16"]
    got = setup["runs"][run]
    assert abs(got["grad_norm"] - gn) <= 1e-2 * gn, (got["grad_norm"], gn)
    for n, want in after.items():
        bound = 2 * LR + 2.0 ** -7 * np.abs(want)
        assert (np.abs(got["params"][n] - want) <= bound).all(), n


F32_RUNS = ["baseline-f32", "pipeline-f32", "baseline-pod-f32"]


@pytest.mark.parametrize("run", F32_RUNS)
def test_f32_loss_and_grads_match_one_process(setup, port_ref, run):
    loss, grads, _, _ = port_ref
    got = setup["runs"][run]
    assert abs(got["loss"] - loss) <= F32["loss"], (got["loss"], loss)
    for n, want in grads.items():
        np.testing.assert_allclose(
            got["grads"][n], want, rtol=0,
            atol=F32["grad_rel"] * np.abs(want).max() + 1e-30, err_msg=n)


@pytest.mark.parametrize("run", F32_RUNS)
def test_f32_step_matches_one_process(setup, port_ref, run):
    _, grads, gn, after = port_ref
    got = setup["runs"][run]
    assert abs(got["grad_norm"] - gn) <= F32["norm_rel"] * gn, \
        (got["grad_norm"], gn)
    start = _by_name(setup["trees"]["f32"], setup["tcfg"])
    held = {n: _torch_dist.assert_first_step(
        got["params"][n], want, start[n], grads[n], gn, lr=LR,
        grad_rel=F32["grad_rel"], norm_rel=F32["norm_rel"], name=n)
        for n, want in after.items()}
    # the bound is far below lr almost everywhere, so no slice of ZeRO-1
    # can be skipped unseen
    assert min(held.values()) >= _torch_dist.HELD, held


def test_sharded_serving_matches_jax_step(setup):
    """Prefill then decode, each rank its 2 rows and its half of the
    heads, teacher-forced, against the JAX package's jitted ``lm.step``
    on the whole batch."""
    jcfg, params = setup["jcfg"], setup["params"]
    got = setup["runs"]["serve"]
    jstep = jax.jit(lambda p, c, t: jlm.step(p, jcfg, c, t))
    cache = jlm.init_cache(params, jcfg, SERVE_B, max_seq=PROMPT + STEPS + 1)
    for i, t in enumerate(setup["feeds"]):
        want, cache = jstep(params, cache, jnp.asarray(t))
        np.testing.assert_allclose(got["logits"][i], _np(want), rtol=0,
                                   atol=SERVE_ATOL, err_msg=f"feed {i}")
    assert got["pos"] == PROMPT + STEPS
    assert got["heads"] == jcfg.n_kv_heads // 2


@pytest.mark.parametrize("case", list(REFUSE))
def test_refusals_name_item_8c(setup, case):
    msg = setup["runs"]["refuse"]["messages"][list(REFUSE).index(case)]
    assert msg is not None, f"{case}: did not raise"
    assert "ROADMAP item 8c" in msg, msg

