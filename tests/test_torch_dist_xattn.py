"""X layers, whisper's encoder and attention whose heads do not split over
tp, on the port's distributed runtime (``repro_torch.launch.steps``) on a
4-rank gloo group of CPU processes, against the JAX package on one device:

  * llama-vision-reduced ("GGGXG", one X layer) at data 2 x tp 2;
  * whisper-tiny-reduced (its encoder and X layers) at data 2 x tp 2;
  * whisper-tiny-reduced with 6 query and 6 KV heads at tp 4: the heads
    split over t = 2 ranks (``tensor_parallel.attn_split``), the other
    two ranks hold copies, and the attention's collectives run over the
    rank's block of 2.

Each X layer's gate is 0.5 in the JAX tree (0 at init would leave the
memory out), and the stub frontend's inputs come from a seeded numpy
generator, rounded to bf16 as the JAX package takes them.  Training runs
in f32 with both packages' ``lm.PDTYPE`` at f32 (``tests/
test_torch_dist_pipeline.py``'s whisper run: in bf16 the JAX package's
encoder rounds its norms and residuals where the port's f32 ones do
not), against the JAX runtime's ``build_loss`` and ``jax.grad``: loss
within 1e-5, each gradient within 1e-4 of its largest entry, the grad
norm within 1e-5 relative.  Serving in f32 (the memory made once by
``init_cache``, whisper's through the encoder over tp), teacher-forced,
against the port's one-process ``lm.step`` (atol 1e-5: the same f32
arithmetic summed over the ranks) and the JAX package's jitted
``lm.step`` at ``tests/test_torch_model.py``'s 2e-2: the jitted reference
and the port's one-process step, which ``tests/test_torch_attn_families.py``
holds to the reference run op by op, differ by up to 8.3e-3 in f32 on
llama-vision's decode steps and 2.8e-4 on whisper's prefill.
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
from repro.distributed import baseline as jbaseline  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402
import _torch_dist  # noqa: E402

LOSS_TOL, GRAD_REL, NORM_REL = 1e-5, 1e-4, 1e-5
N_MICRO, MB, SEQ = 2, 2, 16
XATTN_GATE = 0.5
#: run -> (arch, overrides, mesh, (data, tp, the attention's ranks))
RUNS = {
    "llama-vision-tp2": ("llama-3.2-vision-11b", {}, (2, 2), (2, 2, 2)),
    "whisper-tp2": ("whisper-tiny", {}, (2, 2), (2, 2, 2)),
    "whisper-6-heads-tp4": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6},
                            (1, 4), (1, 4, 2)),
}
SERVE_B, PROMPT, STEPS, SERVE_ATOL, ONE_ATOL = 2, 8, 4, 2e-2, 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _jcfg(arch, over):
    return dataclasses.replace(jconfigs.get_reduced(arch), **over)


def _params(arch, over):
    cfg = _jcfg(arch, over)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    for i, ch in enumerate(cfg.layer_pattern):
        if ch == "X":
            g = params["groups"][i]
            g["xattn_gate"] = jnp.full_like(g["xattn_gate"], XATTN_GATE)
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


def _by_name(tree, arch, over):
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    return {n: p.numpy() for n, p in convert.from_jax_params(
        _np(tree), cfg, device="cpu", dtype=torch.float32).named_parameters()}


def _inputs(arch, over, rows):
    """(tokens (N_MICRO, MB, SEQ + 1), the frontend's inputs of ``rows``
    rows, bf16-rounded)."""
    cfg = _jcfg(arch, over)
    rng = np.random.default_rng(len(arch) + 5)
    toks = rng.integers(0, cfg.vocab, (N_MICRO, MB, SEQ + 1), dtype=np.int32)
    x = rng.standard_normal((rows, cfg.frontend_tokens,
                             cfg.frontend_dim)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return toks, {"vision" if cfg.family == "vlm" else "frames": x}


def _serve_feeds(arch):
    cfg = jconfigs.get_reduced(arch)
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab, (SERVE_B, PROMPT + STEPS), dtype=np.int32)
    return [toks[:, :PROMPT]] + [toks[:, PROMPT + i:PROMPT + i + 1]
                                 for i in range(STEPS)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    runs = []
    for arch, over, mesh, _ in RUNS.values():
        toks, extra = _inputs(arch, over, N_MICRO * MB)
        runs.append(dict(kind="train", arch=arch, overrides=over,
                         tree=_np(_params(arch, over)), dtype="f32",
                         mode="baseline", mesh=mesh, n_micro=N_MICRO,
                         tokens=toks.reshape(N_MICRO * MB, SEQ + 1),
                         extra=extra, memory_f32=True))
    for arch, over, mesh, _ in RUNS.values():
        runs.append(dict(kind="serve", arch=arch, overrides=over, mesh=mesh,
                         tree=_np(_params(arch, over)), dtype="f32",
                         feeds=_serve_feeds(arch), max_seq=PROMPT + STEPS,
                         extra=_inputs(arch, over, SERVE_B)[1]))
    got = _torch_dist.launch(tmp_path_factory.mktemp("dist_xattn"), runs)
    return {"train": dict(zip(RUNS, got[:len(RUNS)])),
            "serve": dict(zip(RUNS, got[len(RUNS):]))}


@pytest.fixture(scope="module")
def references():
    """{run: (loss, grads by name)}: the JAX runtime in f32, its
    ``PDTYPE`` at f32, on one device."""
    out = {}
    for run, (arch, over, *_) in RUNS.items():
        cfg, params = _jcfg(arch, over), _params(arch, over)
        toks, extra = _inputs(arch, over, N_MICRO * MB)
        loss_fn = jbaseline.build_loss(cfg, remat=False)

        def loss(p, loss_fn=loss_fn, toks=toks, extra=extra):
            return sum(loss_fn(p, {"tokens": toks[m], "extra": {
                k: jnp.asarray(v[m * MB:(m + 1) * MB])
                for k, v in extra.items()}})
                for m in range(N_MICRO)) / N_MICRO

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jlm, "PDTYPE", jnp.float32)
            value, grads = jax.jit(jax.value_and_grad(loss))(params)
        out[run] = (float(value), _by_name(grads, arch, over))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_run_splits_the_attention(results, run):
    got = results["train"][run]
    assert (got["layout"]["data"], got["layout"]["tp"],
            got["attn_ranks"]) == RUNS[run][3]


@pytest.mark.parametrize("run", list(RUNS))
def test_cross_attention_over_tp_matches_jax(results, references, run):
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
def test_cross_attention_serving_over_tp_matches_lm_step(results, run):
    arch, over, *_ = RUNS[run]
    cfg = _jcfg(arch, over)
    tcfg = dataclasses.replace(configs.get_reduced(arch), **over)
    params = _params(arch, over)
    extra = _inputs(arch, over, SERVE_B)[1]
    got = results["serve"][run]
    one = convert.from_jax_params(_np(params), tcfg, device="cpu",
                                  dtype=torch.float32)
    tcache = lm.init_cache(one, tcfg, SERVE_B, PROMPT + STEPS, device="cpu",
                           extra={k: torch.tensor(v)
                                  for k, v in extra.items()})
    jstep = jax.jit(lambda p, c, t: jlm.step(p, cfg, c, t))
    jcache = jlm.init_cache(params, cfg, SERVE_B, max_seq=PROMPT + STEPS,
                            extra={k: jnp.asarray(v)
                                   for k, v in extra.items()})
    for i, t in enumerate(_serve_feeds(arch)):
        want, tcache = lm.step(one, tcfg, tcache, torch.from_numpy(t))
        np.testing.assert_allclose(got["logits"][i], want.numpy(), rtol=0,
                                   atol=ONE_ATOL, err_msg=f"feed {i}")
        jwant, jcache = jstep(params, jcache, jnp.asarray(t))
        np.testing.assert_allclose(got["logits"][i], _np(jwant), rtol=0,
                                   atol=SERVE_ATOL, err_msg=f"feed {i}")
    assert got["pos"] == PROMPT + STEPS
