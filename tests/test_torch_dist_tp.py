"""Tensor parallelism past the G and L layers (``repro_torch.distributed.
tensor_parallel``) on a 4-rank gloo group of CPU processes against the JAX
package on one device:

  * tp 4 with 2 KV heads (granite-8b- and chatglm3-6b-reduced): each rank
    holds the one KV head its query heads read, and the two ranks that
    share it sum their gradients for it;
  * zamba2-7b-reduced (M and H layers) and rwkv6-reduced (R layers) at
    tp 4, by head;
  * serving with the context-parallel KV cache (each rank a slice of the
    cache's length): granite-8b-reduced asked for it, chatglm3-6b-reduced
    by default (its 2 KV heads do not divide over 4), gemma3-12b-reduced
    with its windowed layers' rings split too and its prompt past the
    window; a rank whose slice holds no valid key yet (lse = -inf) must
    weigh nothing; and zamba2- and rwkv6-reduced at tp 4.

Training runs in f32 against the JAX runtime's loss on one device
(``repro.distributed.baseline.build_loss``, averaged over the microbatches)
and its ``jax.grad``: loss within 1e-5, each gradient within 1e-4 of its
largest entry, the grad norm within 1e-5 relative (the bounds of
``tests/test_torch_dist_pipeline.py``), and every parameter after the step
within what those bounds leave of an AdamW first step written out from
the reference's gradient (``_torch_dist.assert_first_step``) and within
f32's roundings of the step written out from the run's own gradient
(``_torch_dist.assert_own_step``).  Serving in
bf16, teacher-forced, against the JAX package's jitted ``lm.step``, atol
2e-2 (``tests/test_torch_model.py``'s bound).

Also, with no process group: ``shard`` then ``unshard`` is the identity
for every parameter of every reduced architecture at tp 4, and gives the
full models' shapes at tp 16; and rank 0's
collectives recorded in the gloo run equal those of a meta trace of the
same step on a fake 4-rank group (``launch.dryrun``).
"""
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
from repro_torch.distributed import pipeline  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpar  # noqa: E402
from repro_torch.distributed.collectives import Axis  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402
from _torch_sim import port_obs_isolation  # noqa: E402
import _torch_dist  # noqa: E402

assert port_obs_isolation  # the autouse fixture, imported to apply here

LOSS_TOL, GRAD_REL, NORM_REL = 1e-5, 1e-4, 1e-5
LR = 3e-4
N_MICRO, MB, SEQ = 2, 2, 16
MESH = (1, 4)
#: run -> arch: the baseline train step at data 1 x model 4, in f32
TRAIN = {"granite-tp4-kv2": "granite-8b", "chatglm3-tp4-kv2": "chatglm3-6b",
         "zamba2-tp4": "zamba2-7b", "rwkv6-tp4": "rwkv6-1.6b"}
#: run -> (arch, kv_shard, prompt, decode steps, max_seq): serving at
#: data 1 x model 4 in bf16
SERVE = {"granite-context": ("granite-8b", "context", 8, 4, 32),
         "chatglm3-context": ("chatglm3-6b", "heads", 8, 4, 32),
         "gemma3-context-ring": ("gemma3-12b", "heads", 40, 4, 64),
         "zamba2-tp4": ("zamba2-7b", "heads", 8, 4, 32),
         "rwkv6-tp4": ("rwkv6-1.6b", "heads", 8, 4, 32)}
SERVE_B = 2
SERVE_ATOL = 2e-2


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _by_name(tree, cfg):
    return {n: p.numpy() for n, p in convert.from_jax_params(
        _np(tree), cfg, device="cpu", dtype=torch.float32).named_parameters()}


def _tokens(arch):
    cfg = jconfigs.get_reduced(arch)
    rng = np.random.default_rng(len(arch))
    return rng.integers(0, cfg.vocab, (N_MICRO, MB, SEQ + 1), dtype=np.int32)


def _serve_tokens(arch, prompt, n):
    cfg = jconfigs.get_reduced(arch)
    return np.random.default_rng(7 + len(arch)).integers(
        0, cfg.vocab, (SERVE_B, prompt + n), dtype=np.int32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    runs = []
    for arch in TRAIN.values():
        params = jlm.init_params(jconfigs.get_reduced(arch),
                                 jax.random.PRNGKey(0))
        f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        runs.append(dict(kind="train", arch=arch, tree=_np(f32), dtype="f32",
                         mode="baseline", mesh=MESH, n_micro=N_MICRO,
                         tokens=_tokens(arch).reshape(N_MICRO * MB,
                                                      SEQ + 1)))
    for arch, kv_shard, prompt, n, max_seq in SERVE.values():
        params = jlm.init_params(jconfigs.get_reduced(arch),
                                 jax.random.PRNGKey(0))
        toks = _serve_tokens(arch, prompt, n)
        feeds = [toks[:, :prompt]] + [toks[:, prompt + i:prompt + i + 1]
                                      for i in range(n)]
        runs.append(dict(kind="serve", arch=arch, tree=_np(params),
                         mesh=MESH, feeds=feeds, max_seq=max_seq,
                         kv_shard=kv_shard))
    got = _torch_dist.launch(tmp_path_factory.mktemp("dist_tp"), runs)
    return {"train": dict(zip(TRAIN, got[:len(TRAIN)])),
            "serve": dict(zip(SERVE, got[len(TRAIN):]))}


@pytest.fixture(scope="module")
def references():
    """{run: (loss, grads by name, start by name)}: the JAX runtime in f32
    on one device."""
    out = {}
    for run, arch in TRAIN.items():
        cfg = jconfigs.get_reduced(arch)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jlm.init_params(cfg, jax.random.PRNGKey(0)))
        toks = _tokens(arch)
        loss_fn = jbaseline.build_loss(cfg, remat=False)

        def loss(p, loss_fn=loss_fn, toks=toks):
            return sum(loss_fn(p, {"tokens": toks[m]})
                       for m in range(N_MICRO)) / N_MICRO

        value, grads = jax.jit(jax.value_and_grad(loss))(params)
        tcfg = configs.get_reduced(arch)
        out[run] = (float(value), _by_name(grads, tcfg),
                    _by_name(params, tcfg))
    return out


@pytest.mark.parametrize("run", list(TRAIN))
def test_tp4_train_matches_jax(results, references, run):
    loss, grads, start = references[run]
    got = results["train"][run]
    assert got["layout"] == {"stage": 1, "data": 1, "tp": 4}
    assert abs(got["loss"] - loss) <= LOSS_TOL, (got["loss"], loss)
    assert got["grads"].keys() == grads.keys()
    for n, want in grads.items():
        np.testing.assert_allclose(
            got["grads"][n], want, rtol=0,
            atol=GRAD_REL * np.abs(want).max() + 1e-30, err_msg=n)
    gn = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                           for g in grads.values())))
    assert abs(got["grad_norm"] - gn) <= NORM_REL * gn, (got["grad_norm"], gn)
    # the step, held entry by entry to AdamW's first step written out from
    # the reference's gradient (both the reference and "written" the same)
    c = min(1.0, 1.0 / gn)
    for n, g in grads.items():
        g64 = g.astype(np.float64)
        written = start[n] - LR * (c * g64 / (c * np.abs(g64) + 1e-8)
                                   + 0.1 * start[n])
        _torch_dist.assert_first_step(
            got["params"][n], written, start[n], g, gn, lr=LR,
            grad_rel=GRAD_REL, norm_rel=NORM_REL, name=n)
    # and within f32's roundings of the step written out from the run's
    # own gradient and norm, which a shard left undone fails at most of a
    # parameter's entries (the first-step bound is loose where a gradient
    # sits near its tolerance, as in mamba2's 8 A_log)
    seen = {n: _torch_dist.assert_own_step(
        got["params"][n], start[n], got["grads"][n], got["grad_norm"],
        lr=LR, name=n) for n in grads}
    assert min(seen.values()) >= _torch_dist.HELD, seen


@pytest.mark.parametrize("run", list(SERVE))
def test_tp4_serving_matches_jax_step(results, run):
    arch, kv_shard, prompt, n, max_seq = SERVE[run]
    cfg = jconfigs.get_reduced(arch)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    toks = _serve_tokens(arch, prompt, n)
    feeds = [toks[:, :prompt]] + [toks[:, prompt + i:prompt + i + 1]
                                  for i in range(n)]
    got = results["serve"][run]
    jstep = jax.jit(lambda p, c, t: jlm.step(p, cfg, c, t))
    cache = jlm.init_cache(params, cfg, SERVE_B, max_seq=max_seq)
    for i, t in enumerate(feeds):
        want, cache = jstep(params, cache, jnp.asarray(t))
        np.testing.assert_allclose(got["logits"][i], _np(want), rtol=0,
                                   atol=SERVE_ATOL, err_msg=f"feed {i}")
    assert got["pos"] == prompt + n


def test_context_cache_splits_every_attention_layer(results):
    """The context-split runs hold a slice of each cache on rank 0; in the
    granite run ranks 2 and 3 hold no key the decode reached (valid
    positions end at prompt + steps = 12 of 32, 8 slots a rank): their
    lse is -inf and they must weigh nothing, or the logits above would
    miss the reference."""
    for run in ("granite-context", "chatglm3-context", "gemma3-context-ring"):
        arch = SERVE[run][0]
        cfg = configs.get_reduced(arch)
        attn = sum(ch in "GL" for ch in (cfg.layer_pattern * cfg.n_layers)
                   [:cfg.n_layers])
        assert len(results["serve"][run]["context"]) == attn, run
    assert results["serve"]["granite-context"]["context"][0] == [0, 32] or \
        tuple(results["serve"]["granite-context"]["context"][0]) == (0, 32)
    prompt, n, max_seq = SERVE["granite-context"][2:]
    assert prompt + n <= 2 * max_seq // 4
    # gemma3's local layers keep rings of its window (32) split in 8-slot
    # pieces, its global layer the whole 64
    windows = {tuple(c)[1] for c in results["serve"]["gemma3-context-ring"]
               ["context"]}
    assert windows == {32, 64}
    for run in ("zamba2-tp4", "rwkv6-tp4"):
        assert results["serve"][run]["context"] == []


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_shard_then_unshard_is_the_identity(arch):
    """Every parameter cut for each rank and put back together: the
    reduced model's values at tp 4; the full model's shapes at tp 16 (on
    the meta device), each shard the same size and holding the whole
    runs on every rank."""
    for cfg, tp, device in ((configs.get_reduced(arch), 4, "cpu"),
                            (configs.get(arch), 16, "meta")):
        tpar.check_tp(cfg, tp)
        structs = steps.param_structs(cfg)
        specs = pipeline.param_specs(cfg, structs, tp_axis="model",
                                     tp_size=tp)
        for name, shape in pipeline._named_shapes(structs).items():
            dim = steps._shard_dim(specs[name], "model")
            if dim is None:
                continue
            t = torch.arange(int(np.prod(shape)), dtype=torch.float64,
                             device=device).reshape(shape)
            parts = [tpar.shard(cfg, name, t, dim, Axis(None, tp, r))
                     for r in range(tp)]
            assert all(p.shape == parts[0].shape for p in parts), name
            back = tpar.unshard(cfg, name, parts, dim)
            assert back.shape == t.shape, name
            if device == "cpu":
                assert torch.equal(back, t), name
            held = sum(p.shape[dim] for p in parts) // \
                tpar.share(cfg, name, tp)
            whole = sum(n for n, split in tpar.segments(cfg, name,
                                                        shape[dim])
                        if not split)
            assert held == shape[dim] + whole * (tp // tpar.share(
                cfg, name, tp) - 1), name


def test_recorded_schedule_equals_the_meta_trace(results):
    """Rank 0's collectives in the gloo run of granite-8b-reduced at tp 4
    with 2 KV heads (its step: gradients and the optimizer's update) equal
    those of the same step traced on meta tensors as rank 0 of a fake
    4-rank group, record for record."""
    from repro_torch.distributed.taskgraph import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get_reduced("granite-8b")
    cell = ShapeCell("test", SEQ, N_MICRO * MB, "train")
    with dryrun.fake_group(4, 0):
        mesh = make_mesh(MESH, ("data", "model"), device_type="cpu")
        step = steps.build_baseline_train(cfg, mesh, cell, n_micro=N_MICRO,
                                          device="meta")
        params = step.shard(lm.LM(cfg, "meta"))
        with torch.no_grad():
            params = params.to(torch.float32)
        args = (params, step.init_opt(params), {"tokens": torch.empty(
            (N_MICRO * MB, SEQ + 1), dtype=torch.int32, device="meta")})
        traced = dryrun.trace(step, args)["records"]
    got = results["train"]["granite-tp4-kv2"]["schedule"]
    assert len(got) > 0
    assert traced == got
