"""The port's floorplanned pipeline (``repro_torch.launch.steps.
build_tapa_train``) on a 4-rank gloo group of CPU processes against the
JAX package on one device, for the families and schedules the
granite-8b runs of ``tests/test_torch_dist_runtime.py`` do not reach:

  * granite-moe-3b-a800m-reduced, 2 stages x data 2, and the baseline at
    data 4: the MoE aux loss, taken over every data rank's tokens, enters
    both as in the runtime's loss on one device;
  * granite-8b-reduced at 4 layers in 4 stages with boundary depths
    [1, 3, 2] (microbatch m enters stage s at tick m + [0, 1, 4, 6][s]);
  * zamba2-7b-reduced at 12 layers (two groups of "MMMMMH") in 2 stages x
    data 2: the x0 skip stream travels with x, the shared blocks' grads
    are summed over the stages;
  * whisper-tiny-reduced in 2 stages x data 2, its X layers' gates at
    0.5: the memory (the encoder over seeded stub frames) is made on each
    stage, and the encoder's and the frontend's grads are summed over the
    stages.

Each in f32 against the JAX runtime's loss on one device
(``repro.distributed.baseline.build_loss``, averaged over the
microbatches) and its ``jax.grad``: loss within 1e-5 and each gradient
within 1e-4 of its largest entry (``tests/test_torch_train.py``'s f32
bounds: the same f32 arithmetic in other orders).  ``lm.loss_fn`` would
not do for the MoE model: it runs the model over all S + 1 tokens of a row
and its aux loss routes the last one too, where the runtime runs the S
inputs.

And the reference pipeline's fault: its aux term is divided by n_micro x
n_stages (``repro/distributed/pipeline.py:242``).  The JAX package's own
pipeline runs once, in a subprocess with two host devices, on
granite-moe-reduced in bf16 (its stage buffers are bf16): its loss is the
plain loss less 0.01 aux (1 - 1/S), within the JAX pipeline test's 1e-3,
where the port's bf16 pipeline equals the plain loss.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import baseline as jbaseline  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.model import convert  # noqa: E402
import _torch_dist  # noqa: E402

LOSS_TOL, GRAD_REL, NORM_REL = 1e-5, 1e-4, 1e-5
BF16_LOSS = 1e-3


def _plan(n, depths, slots=None):
    return dict(mode="tapa", n_stages=n, groups_per_stage=1,
                stage_slots=slots or [(0, c) for c in range(n)],
                boundary_depth=depths, tp=1, crossing_cost=0.0)


def _run(arch, mode, mesh, plan, *, n_micro=2, mb=2, seq=16, dtype="f32",
         overrides=None, frames=False, memory_f32=False):
    """``memory_f32``: both packages' ``lm.PDTYPE`` set to f32, as
    ``tests/test_torch_train.py`` sets it for whisper: the memory is cast
    to it, and in bf16 the JAX package's encoder then rounds its norms and
    residuals to bf16 where the port's f32 ones do not."""
    return dict(arch=arch, mode=mode, mesh=mesh, plan=plan, n_micro=n_micro,
                mb=mb, seq=seq, dtype=dtype, overrides=overrides or {},
                frames=frames, memory_f32=memory_f32)


#: run -> its inputs; the layout (stage, data, tp) the builder must make
RUNS = {
    "moe-pipeline": _run("granite-moe-3b-a800m", "tapa", (2, 2),
                         _plan(2, [1]), mb=4),
    "moe-baseline": _run("granite-moe-3b-a800m", "baseline", (4, 1), None,
                         mb=4),
    "moe-pipeline-bf16": _run("granite-moe-3b-a800m", "tapa", (2, 2),
                              _plan(2, [1]), mb=4, dtype="bf16"),
    "four-stages": _run("granite-8b", "tapa", (1, 4), _plan(4, [1, 3, 2]),
                        n_micro=3, overrides={"n_layers": 4}),
    "zamba2": _run("zamba2-7b", "tapa", (2, 2), _plan(2, [2]),
                   overrides={"n_layers": 12}),
    "whisper": _run("whisper-tiny", "tapa", (2, 2), _plan(2, [1]),
                    frames=True, memory_f32=True),
}
LAYOUT = {"moe-pipeline": (2, 2, 1), "moe-baseline": (1, 4, 1),
          "moe-pipeline-bf16": (2, 2, 1), "four-stages": (4, 1, 1),
          "zamba2": (2, 2, 1), "whisper": (2, 2, 1)}
#: the X layers' cross-attention gate in both trees: the init's 0 would
#: leave the memory out of the loss
XATTN_GATE = 0.5
LR = 3e-4

_JAX_PIPELINE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh
    from repro import configs
    from repro.model import lm
    from repro.distributed import pipeline as pp
    from repro.distributed.sharding import TpuPlan

    cfg = configs.get_reduced("granite-moe-3b-a800m")
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jnp.asarray(np.asarray(json.loads(sys.argv[1]), np.int32))
    plan = TpuPlan(mode="tapa", n_stages=2, groups_per_stage=1,
                   stage_slots=[(0, 0), (0, 1)], boundary_depth=[1], tp=1,
                   crossing_cost=0.0)
    rmesh = make_mesh((2, 1, 1), ("stage", "data", "tp"))
    pparams = pp.to_pipeline_params(params, 2)
    loss_fn = pp.build_train_loss(cfg, plan, rmesh, n_micro=tokens.shape[0],
                                  remat=False)
    with rmesh:
        specs = pp.param_specs(cfg, pparams, tp_axis="tp", tp_size=1,
                               stage_axis="stage")
        shard = jax.tree.map(lambda s: NamedSharding(rmesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
        out = float(jax.jit(loss_fn)(jax.device_put(pparams, shard),
                                     {"tokens": tokens}))
    print("JSON" + json.dumps({"pipeline_loss": out}))
""")


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _by_name(tree, arch, overrides):
    """A JAX tree as the port's {name: f32 array}."""
    tcfg = dataclasses.replace(configs.get_reduced(arch), **overrides)
    return {n: p.numpy() for n, p in convert.from_jax_params(
        _np(tree), tcfg, device="cpu", dtype=torch.float32).named_parameters()}


def _jax_params(run):
    cfg = dataclasses.replace(jconfigs.get_reduced(run["arch"]),
                              **run["overrides"])
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    for i, ch in enumerate(cfg.layer_pattern):
        if ch == "X":
            g = params["groups"][i]
            g["xattn_gate"] = jnp.full_like(g["xattn_gate"], XATTN_GATE)
    if run["dtype"] == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return cfg, params


def _inputs(run, cfg):
    """(tokens (n_micro, mb, S + 1), extra or None) from a seeded numpy
    generator; whisper's stub frames (mb rows, every microbatch's),
    rounded to bf16 as the JAX package takes them."""
    rng = np.random.default_rng(len(run["arch"]) + run["n_micro"])
    toks = rng.integers(0, cfg.vocab, (run["n_micro"], run["mb"],
                                       run["seq"] + 1), dtype=np.int32)
    if not run["frames"]:
        return toks, None
    frames = rng.standard_normal((run["mb"], cfg.frontend_tokens,
                                  cfg.frontend_dim)).astype(np.float32)
    frames = np.asarray(jnp.asarray(frames, jnp.bfloat16).astype(
        jnp.float32))
    return toks, {"frames": frames}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    runs = []
    for run in RUNS.values():
        cfg, params = _jax_params(run)
        toks, extra = _inputs(run, cfg)
        if run["mode"] != "tapa":
            toks = toks.reshape(-1, toks.shape[-1])
        runs.append(dict(run, kind="train", tree=_np(params), tokens=toks,
                         extra=extra))
    got = _torch_dist.launch(tmp_path_factory.mktemp("dist_pipeline"), runs)
    return dict(zip(RUNS, got))


@pytest.fixture(scope="module")
def references():
    """{run: (loss, grads by name, or None in bf16)}: the JAX runtime on
    one device, once for each set of inputs."""
    out, done = {}, {}
    for name, run in RUNS.items():
        key = tuple((k, str(v)) for k, v in run.items()
                    if k not in ("mode", "mesh", "plan"))
        if key in done:
            out[name] = done[key]
            continue
        cfg, params = _jax_params(run)
        toks, extra = _inputs(run, cfg)
        loss_fn = jbaseline.build_loss(cfg, remat=False)
        jextra = extra and {k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in extra.items()}

        def loss(p):
            return sum(loss_fn(p, {"tokens": toks[m], "extra": jextra})
                       for m in range(run["n_micro"])) / run["n_micro"]

        if run["dtype"] == "bf16":
            out[name] = done[key] = (float(jax.jit(loss)(params)), None)
            continue
        with pytest.MonkeyPatch.context() as mp:
            if run["memory_f32"]:
                mp.setattr(jlm, "PDTYPE", jnp.float32)
            value, grads = jax.jit(jax.value_and_grad(loss))(params)
        out[name] = done[key] = (float(value), _by_name(
            grads, run["arch"], run["overrides"]))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_run_lays_out_the_mesh(results, run):
    got = results[run]["layout"]
    assert (got["stage"], got["data"], got["tp"]) == LAYOUT[run]


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if RUNS[r]["dtype"] == "f32"])
def test_f32_loss_and_grads_match_jax(results, references, run):
    loss, grads = references[run]
    got = results[run]
    assert abs(got["loss"] - loss) <= LOSS_TOL, (got["loss"], loss)
    assert got["grads"].keys() == grads.keys()
    for n, want in grads.items():
        np.testing.assert_allclose(
            got["grads"][n], want, rtol=0,
            atol=GRAD_REL * np.abs(want).max() + 1e-30, err_msg=n)


def test_moe_pipeline_equals_the_baseline(results):
    """Stage 2 x data 2 against data 4: the same loss and gradients (both
    take the aux loss over every data rank's tokens)."""
    a, b = results["moe-pipeline"], results["moe-baseline"]
    assert abs(a["loss"] - b["loss"]) <= LOSS_TOL
    for n, want in b["grads"].items():
        np.testing.assert_allclose(
            a["grads"][n], want, rtol=0,
            atol=GRAD_REL * np.abs(want).max() + 1e-30, err_msg=n)
    assert abs(a["grad_norm"] - b["grad_norm"]) <= NORM_REL * b["grad_norm"]
    # the step, each data rank updating its ZeRO-1 slice, held entry by
    # entry to what those bounds leave of an AdamW first step: far below lr
    # where a gradient stands clear of its tolerance
    _, params = _jax_params(RUNS["moe-baseline"])
    start = _by_name(params, "granite-moe-3b-a800m", {})
    held = {n: _torch_dist.assert_first_step(
        a["params"][n], want, start[n], b["grads"][n], b["grad_norm"],
        lr=LR, grad_rel=GRAD_REL, norm_rel=NORM_REL, name=n)
        for n, want in b["params"].items()}
    assert min(held.values()) >= _torch_dist.HELD, held


def test_reference_pipeline_carries_one_over_s_of_the_aux(references,
                                                          results):
    """The JAX package's pipeline loss on granite-moe-reduced (bf16, 2
    stages) is its plain loss less 0.01 aux (1 - 1/2); the port's equals
    the plain loss (ROADMAP §3)."""
    run = RUNS["moe-pipeline-bf16"]
    cfg, params = _jax_params(run)
    toks, _ = _inputs(run, cfg)
    aux = float(np.mean([jlm.forward(params, cfg,
                                     jnp.asarray(toks[m][:, :-1]))[1]
                         for m in range(run["n_micro"])]))
    plain = references["moe-pipeline-bf16"][0]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", _JAX_PIPELINE,
                        json.dumps(toks.tolist())], env=env, cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref_pipe = json.loads(next(x for x in r.stdout.splitlines()
                               if x.startswith("JSON"))[4:])["pipeline_loss"]
    gap = 0.01 * aux * (1 - 1 / 2)
    assert gap > 10 * BF16_LOSS, (aux, gap)
    assert abs(ref_pipe - (plain - gap)) < BF16_LOSS, (ref_pipe, plain, gap)
    assert abs(results["moe-pipeline-bf16"]["loss"] - plain) < BF16_LOSS
