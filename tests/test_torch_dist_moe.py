"""MoE experts and Adafactor over the port's distributed runtime
(``repro_torch.launch.steps``) on a 4-rank gloo group of CPU processes,
against the JAX package on one device:

  * granite-moe-3b-reduced at tp 4: its 8 experts expert-parallel (2 a
    rank, ``tensor_parallel.moe_placement``), and with ``n_experts=6``
    FFN-parallel (each expert's 64-wide FFN cut in 16s); every tp rank
    must route every token alike (``_torch_dist._same_routes``);
  * arctic-480b-reduced (Adafactor, experts and a dense residual MLP) at
    data 2 x tp 2 (ZeRO-1) and at 2 stages x tp 2.

Training runs in f32 against the JAX runtime's ``build_loss`` averaged
over the microbatches and its ``jax.grad``: loss within 1e-5, each
gradient within 1e-4 of its largest entry, the grad norm within 1e-5
relative (``tests/test_torch_dist_tp.py``'s bounds).  Adafactor is then
held to the reference's ``clip_by_global_norm`` and ``adafactor_update``
on its stacked tree, (G, ...) for the baseline and (S, Gs, ...) for the
pipeline: two steps from the same standard-normal gradients (numpy seed
30), each rank updating its piece with the sums over tp, the data slices
and the stages; parameters and every ``vr`` / ``vc`` / ``v`` within
rtol 1e-6 (``tests/test_torch_adafactor_stacks.py``'s one-process bound)
and the state within ``STATE_RTOL``, gathered as the whole model's.  The
state is quadratic in the clipped gradient, so it carries twice the clip
scale's relative error (the grad norm, summed over the ranks in another
order, within 1e-6 of the reference's: 1.2e-6 on arctic's embedding vr
at step 1) beside its own rounding.  Serving in f32 (no near-tie of the router between
the packages), teacher-forced, against the port's one-process ``lm.step``
(atol 1e-5: the same f32 arithmetic summed over the ranks) and the JAX
package's jitted ``lm.step`` at ``tests/test_torch_model.py``'s 2e-2 (the
jitted step and the port's one-process one differ by up to 1.9e-3 on
these MoE models' decode steps).
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
from repro.distributed import baseline as jbaseline  # noqa: E402
from repro.distributed import pipeline as jpp  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402
from _torch_sim import port_obs_isolation  # noqa: E402
from test_torch_adafactor_stacks import _ref_state  # noqa: E402
import _torch_dist  # noqa: E402

assert port_obs_isolation  # the autouse fixture, imported to apply here

LOSS_TOL, GRAD_REL, NORM_REL = 1e-5, 1e-4, 1e-5
LR, RTOL, ATOL = 3e-4, 1e-6, 1e-7
#: the sharded state's bound: twice the grad norm's RTOL and as much
#: again for the means' own sums, split over the ranks
STATE_RTOL = 4 * RTOL
N_MICRO, MB, SEQ = 2, 2, 16
PIPE_PLAN = dict(mode="tapa", n_stages=2, groups_per_stage=1,
                 stage_slots=[(0, 0), (0, 1)], boundary_depth=[1], tp=2,
                 crossing_cost=0.0)
#: run -> (arch, overrides, mode, mesh, layout (stage, data, tp, moe))
RUNS = {
    "granite-moe-expert-tp4": ("granite-moe-3b-a800m", {}, "baseline",
                               (1, 4), (1, 1, 4, "expert")),
    "granite-moe-ffn-tp4": ("granite-moe-3b-a800m", {"n_experts": 6},
                            "baseline", (1, 4), (1, 1, 4, "ffn")),
    "arctic-dp2-tp2": ("arctic-480b", {}, "baseline", (2, 2),
                       (1, 2, 2, "expert")),
    "arctic-2-stages-tp2": ("arctic-480b", {}, "tapa", (1, 4),
                            (2, 1, 2, "expert")),
}
#: Adafactor's steps from given gradients
GIVEN_STEPS = 2
#: serving: run -> (arch, overrides, mesh)
SERVE = {"granite-moe-expert-tp4": ("granite-moe-3b-a800m", {}, (1, 4)),
         "granite-moe-ffn-tp4": ("granite-moe-3b-a800m", {"n_experts": 6},
                                 (1, 4)),
         "arctic-dp2-tp2": ("arctic-480b", {}, (2, 2))}
SERVE_B, PROMPT, STEPS, SERVE_ATOL, ONE_ATOL = 2, 8, 4, 2e-2, 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _jcfg(arch, over):
    return dataclasses.replace(jconfigs.get_reduced(arch), **over)


def _tcfg(arch, over):
    return dataclasses.replace(configs.get_reduced(arch), **over)


def _params(arch, over):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jlm.init_params(
        _jcfg(arch, over), jax.random.PRNGKey(0)))


def _by_name(tree, arch, over):
    return {n: p.numpy() for n, p in convert.from_jax_params(
        _np(tree), _tcfg(arch, over), device="cpu",
        dtype=torch.float32).named_parameters()}


def _tokens(arch):
    cfg = jconfigs.get_reduced(arch)
    return np.random.default_rng(len(arch) + 3).integers(
        0, cfg.vocab, (N_MICRO, MB, SEQ + 1), dtype=np.int32)


def _given(params):
    """``GIVEN_STEPS`` trees of standard-normal gradients shaped as
    ``params``."""
    rng = np.random.default_rng(30)
    return [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params) for _ in range(GIVEN_STEPS)]


def _serve_feeds(arch):
    cfg = jconfigs.get_reduced(arch)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, (SERVE_B, PROMPT + STEPS), dtype=np.int32)
    return [toks[:, :PROMPT]] + [toks[:, PROMPT + i:PROMPT + i + 1]
                                 for i in range(STEPS)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    runs = []
    for arch, over, mode, mesh, _ in RUNS.values():
        params = _params(arch, over)
        toks = _tokens(arch)
        run = dict(kind="train", arch=arch, overrides=over, tree=_np(params),
                   dtype="f32", mode=mode, mesh=mesh, plan=PIPE_PLAN,
                   n_micro=N_MICRO, tokens=toks if mode == "tapa"
                   else toks.reshape(N_MICRO * MB, SEQ + 1))
        if _jcfg(arch, over).optimizer == "adafactor":
            run["given_grads"] = [_by_name(g, arch, over)
                                  for g in _given(params)]
        runs.append(run)
    for arch, over, mesh in SERVE.values():
        runs.append(dict(kind="serve", arch=arch, overrides=over, mesh=mesh,
                         tree=_np(_params(arch, over)), dtype="f32",
                         feeds=_serve_feeds(arch), max_seq=PROMPT + STEPS))
    got = _torch_dist.launch(tmp_path_factory.mktemp("dist_moe"), runs)
    return {"train": dict(zip(RUNS, got[:len(RUNS)])),
            "serve": dict(zip(SERVE, got[len(RUNS):]))}


@pytest.fixture(scope="module")
def references():
    """{run: (loss, grads by name)}: the JAX runtime in f32 on one
    device."""
    out = {}
    for run, (arch, over, *_) in RUNS.items():
        cfg, params, toks = _jcfg(arch, over), _params(arch, over), \
            _tokens(arch)
        loss_fn = jbaseline.build_loss(cfg, remat=False)

        def loss(p, loss_fn=loss_fn, toks=toks):
            return sum(loss_fn(p, {"tokens": toks[m]})
                       for m in range(N_MICRO)) / N_MICRO

        value, grads = jax.jit(jax.value_and_grad(loss))(params)
        out[run] = (float(value), _by_name(grads, arch, over))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_run_lays_out_the_mesh_and_places_the_experts(results, run):
    got = results["train"][run]
    lay = got["layout"]
    assert (lay["stage"], lay["data"], lay["tp"], got["moe"]) == \
        RUNS[run][4]


@pytest.mark.parametrize("run", list(RUNS))
def test_moe_over_tp_matches_jax(results, references, run):
    loss, grads = references[run]
    got = results["train"][run]
    assert abs(got["loss"] - loss) <= LOSS_TOL, (got["loss"], loss)
    assert got["grads"].keys() == grads.keys()
    for n, want in grads.items():
        np.testing.assert_allclose(
            got["grads"][n], want, rtol=0,
            atol=GRAD_REL * np.abs(want).max() + 1e-30, err_msg=n)
    gn = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                           for g in grads.values())))
    assert abs(got["grad_norm"] - gn) <= NORM_REL * gn, (got["grad_norm"], gn)


@pytest.mark.parametrize("run", list(RUNS))
def test_every_tp_rank_routes_alike(results, run):
    """Each rank asserted its top_i equal to every tp rank's, for every
    layer's routing of every microbatch (and its recomputation)."""
    cfg = _tcfg(*RUNS[run][:2])
    layers = cfg.n_layers // RUNS[run][4][0]
    assert results["train"][run]["routes"] == 2 * N_MICRO * layers


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if _jcfg(*RUNS[r][:2]).optimizer ==
                                 "adafactor"])
def test_sharded_adafactor_equals_the_reference(results, run):
    arch, over, mode, *_ = RUNS[run]
    cfg = _tcfg(arch, over)
    pipeline = mode == "tapa"
    n_stages = PIPE_PLAN["n_stages"] if pipeline else None
    jp = _params(arch, over)
    js = None
    for i, g in enumerate(_given(jp)):
        if pipeline:
            jp_, g = jpp.to_pipeline_params(jp, n_stages), \
                jpp.to_pipeline_params(g, n_stages)
        else:
            jp_ = jp
        if js is None:
            js = joptim.adafactor_init(jp_)
        clipped, gn = joptim.clip_by_global_norm(g, 1.0)
        jp_, js = joptim.adafactor_update(jp_, clipped, js, lr=LR)
        jp = jpp.from_pipeline_params(jp_) if pipeline else jp_
        got = results["train"][run]["given"][i]
        assert abs(got["grad_norm"] - float(gn)) <= RTOL * float(gn)
        want = _by_name(jp, arch, over)
        for n, w in want.items():
            np.testing.assert_allclose(got["params"][n], w, rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {i} {n}")
        want_state = _ref_state(js, jp_, cfg, pipeline)
        assert got["state"].keys() == want_state.keys()
        for n, st in want_state.items():
            assert set(got["state"][n]) == set(st), n
            for k, v in st.items():
                np.testing.assert_allclose(got["state"][n][k], v,
                                           rtol=STATE_RTOL, atol=0,
                                           err_msg=f"step {i} {n} {k}")


@pytest.mark.parametrize("run", list(SERVE))
def test_moe_serving_over_tp_matches_lm_step(results, run):
    arch, over, _ = SERVE[run]
    cfg = _jcfg(arch, over)
    params = _params(arch, over)
    got = results["serve"][run]
    tcfg = _tcfg(arch, over)
    one = convert.from_jax_params(_np(params), tcfg, device="cpu",
                                  dtype=torch.float32)
    tcache = lm.init_cache(one, tcfg, SERVE_B, PROMPT + STEPS, device="cpu")
    jstep = jax.jit(lambda p, c, t: jlm.step(p, cfg, c, t))
    jcache = jlm.init_cache(params, cfg, SERVE_B, max_seq=PROMPT + STEPS)
    for i, t in enumerate(_serve_feeds(arch)):
        want, tcache = lm.step(one, tcfg, tcache, torch.from_numpy(t))
        np.testing.assert_allclose(got["logits"][i], want.numpy(), rtol=0,
                                   atol=ONE_ATOL, err_msg=f"feed {i}")
        jwant, jcache = jstep(params, jcache, jnp.asarray(t))
        np.testing.assert_allclose(got["logits"][i], _np(jwant), rtol=0,
                                   atol=SERVE_ATOL, err_msg=f"feed {i}")
    assert got["pos"] == PROMPT + STEPS
