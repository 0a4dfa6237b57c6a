"""The port's training path against the JAX package's, on the CPU.

The JAX package's own ``lm.init_params(PRNGKey(0))`` weights are carried
across with ``convert.from_jax_params``, and its gradients mapped the same
way; the same numpy batches (``SyntheticTokens``) go to both.  The port
runs its plain versions here: the kernels' wrappers take tensors on the
CPU to ``ref.py`` and autograd differentiates them.

Tolerances, each with its reason:
  * f32 weights (both sides widened): loss within 1e-5 and each
    parameter's gradient within 1e-4 of its largest entry.  The same f32
    arithmetic summed in other orders; measured ~1e-6.
  * bf16 weights, as initialised: loss within 2e-3, each gradient within
    3e-2 of its largest entry.  bf16 keeps 8 bits (0.4 % a rounding), the
    two frameworks round activations and products at different places,
    and the backward sums those differences over the batch; measured 2.2
    % on granite-8b-reduced's embedding against the jitted reference.
  * five full steps (clip, AdamW, cosine) against the reference's jitted
    ``train_step`` (its ``lax.scan`` body compiled as one program, which
    rounds otherwise than op-by-op dispatch): losses within 3e-3 in bf16,
    whose updated weights land an ulp apart where gradients differ
    (measured 5.8e-4 at step 4, while the loss moves by 0.06), 1e-4 in
    f32; grad norms within 1 %.

The kernels' own backward (plain versions) is held in
``tests/test_torch_train_kernels.py``.
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
from repro.data import SyntheticTokens  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402

B, S = 2, 32
#: (loss atol, gradient tolerance relative to its largest entry) by dtype
TOL = {"f32": (1e-5, 1e-4), "bf16": (2e-3, 3e-2)}
#: the X layers' gate in both trees: the init's 0 would leave the memory
#: out of the loss
XATTN_GATE = 0.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(arch, dtype, **over):
    """(JAX config, JAX params, port config, port params with grads on),
    the same weights, widened to f32 on both sides for "f32"; ``over``
    replaces fields of both reduced configs alike."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    tcfg = dataclasses.replace(configs.get_reduced(arch), **over)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if "X" in jcfg.layer_pattern:
        for i, ch in enumerate(jcfg.layer_pattern):
            if ch == "X":
                g = jparams["groups"][i]
                g["xattn_gate"] = jnp.full_like(g["xattn_gate"], XATTN_GATE)
    if dtype == "f32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    params = convert.from_jax_params(
        tree, tcfg, device="cpu",
        dtype=torch.float32 if dtype == "f32" else None)
    return jcfg, jparams, tcfg, params.requires_grad_(True)


def _batch(cfg, seed=0, step=0):
    """(JAX batch, port batch): SyntheticTokens of (B, S + 1); whisper's
    seeded stub frames as its ``extra``."""
    toks = SyntheticTokens(cfg.vocab, seed=seed).batch(step, 0, B, S)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.n_enc_layers:
        frames = np.random.default_rng(seed + 1).standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        jb["extra"] = {"frames": jnp.asarray(frames, jnp.bfloat16)}
        tb["extra"] = {"frames": torch.from_numpy(frames).to(
            torch.bfloat16)}
    return jb, tb


def _value_and_grad(jcfg, jbatch, jparams):
    """The reference's loss and gradients, jitted as its trainer jits
    them."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(jparams, jbatch)


def _check_grads(params, tcfg, jgrads, dtype, rel):
    """Every port gradient against the JAX gradient of the same leaf,
    within ``rel`` of that leaf's largest entry.  A leaf the loss does not
    reach has no port gradient and a zero JAX one."""
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jgrads)
    want = dict(convert.from_jax_params(
        tree, tcfg, device="cpu",
        dtype=torch.float32 if dtype == "f32" else None).named_parameters())
    n = 0
    for name, p in params.named_parameters():
        w = _np(want[name])
        if p.grad is None:
            assert not w.any(), name
            continue
        assert p.grad.dtype == p.dtype, name
        np.testing.assert_allclose(_np(p.grad), w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-30,
                                   err_msg=name)
        n += 1
    return n


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_granite_loss_and_grads_match_jax(dtype):
    jcfg, jparams, tcfg, params = _models("granite-8b", dtype)
    jb, tb = _batch(jcfg)
    jloss, jgrads = _value_and_grad(jcfg, jb, jparams)
    loss = lm.loss_fn(params, tcfg, tb)
    loss.backward()
    loss_tol, rel = TOL[dtype]
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jloss)) <= loss_tol
    # every leaf, the tied embedding (the gather's scatter-add plus the
    # head's product) among them
    assert _check_grads(params, tcfg, jgrads, dtype, rel) == \
        len(list(params.parameters()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_five_steps_match_jitted_train_step(dtype):
    """The full step (loss, backward, clip 1.0, AdamW at the cosine
    schedule with warm-up 20) against the reference's ``train_step``,
    jitted as ``repro.launch.train`` jits it, from the same weights on the
    same batches."""
    jcfg, jparams, tcfg, params = _models("granite-8b", dtype)

    @jax.jit
    def train_step(params, opt_state, tokens, lr):
        loss, grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, {"tokens": tokens}))(params)
        grads, gn = joptim.clip_by_global_norm(grads, 1.0)
        params, opt_state = joptim.adamw_update(params, grads, opt_state,
                                                lr=lr)
        return params, opt_state, loss, gn

    jopt, opt = joptim.adamw_init(jparams), optim.adamw_init(
        params.named_parameters())
    loss_tol = {"f32": 1e-4, "bf16": 3e-3}[dtype]
    src = SyntheticTokens(jcfg.vocab, seed=0)
    losses = []
    for step in range(5):
        toks = src.batch(step, 0, B, S)
        lr = optim.cosine_schedule(step, peak=3e-3, warmup=20, total=5)
        assert lr == float(np.float32(joptim.cosine_schedule(
            step, peak=3e-3, warmup=20, total=5)))
        jparams, jopt, jloss, jgn = train_step(jparams, jopt,
                                               jnp.asarray(toks), lr)
        loss, gn = train.train_step(params, tcfg, opt, torch.from_numpy(toks),
                                    lr)
        assert abs(float(loss) - float(jloss)) <= loss_tol, step
        assert float(gn) == pytest.approx(float(jgn), rel=1e-2)
        losses.append(float(loss))
        assert all(p.grad is None for p in params.parameters())
    assert int(opt["step"]) == 5
    assert losses[-1] < losses[0]


#: one reduced model of each family that trains on the CPU: the SSM
#: hybrid, the RNN, the MoE, the encoder-decoder with its frames and
#: gemma's two (softcaps and post-norms; 5:1 local:global), and gemma3 at
#: its published head size 256 (both reduced configs widened to it, one
#: local and one global layer): case -> (arch, config fields replaced)
FAMILIES = {"zamba2-7b": ("zamba2-7b", {}),
            "rwkv6-1.6b": ("rwkv6-1.6b", {}),
            "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
            "whisper-tiny": ("whisper-tiny", {}),
            "gemma2-27b": ("gemma2-27b", {}),
            "gemma3-12b": ("gemma3-12b", {}),
            "gemma3-12b-d256": ("gemma3-12b", dict(
                head_dim=256, n_layers=2, layer_pattern="LG"))}


@pytest.mark.parametrize("case", list(FAMILIES))
def test_family_forward_loss_and_chunked_ce_match_jax(case, monkeypatch):
    """In f32 (where the MoE routes no token otherwise): ``forward``'s
    logits and aux, ``loss_fn`` and its gradients, and ``chunked_ce`` over
    the same hidden states, targets and mask (padded to 8 chunks).

    Both models' ``PDTYPE`` is set to f32 here: whisper's encoder input is
    cast to it (``_encode`` in the JAX package, ``_frontend`` here), and in
    bf16 the JAX package's following norm and residual round to bf16 where
    the port's f32 ones do not (logits 3e-4 apart)."""
    arch, over = FAMILIES[case]
    monkeypatch.setattr(jlm, "PDTYPE", jnp.float32)
    monkeypatch.setattr(lm, "PDTYPE", torch.float32)
    jcfg, jparams, tcfg, params = _models(arch, "f32", **over)
    jb, tb = _batch(jcfg, seed=4)
    jlogits, jaux = jax.jit(lambda p, b: jlm.forward(
        p, jcfg, b["tokens"], extra=b.get("extra")))(jparams, jb)
    with torch.no_grad():
        logits, aux = lm.forward(params, tcfg, tb["tokens"],
                                 extra=tb.get("extra"))
    assert logits.shape == (B, S + 1, tcfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=0, atol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-7)
    assert (float(aux) > 0) == bool(tcfg.n_experts)

    jloss, jgrads = _value_and_grad(jcfg, jb, jparams)
    loss = lm.loss_fn(params, tcfg, tb)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= TOL["f32"][0]
    assert _check_grads(params, tcfg, jgrads, "f32", TOL["f32"][1]) > 0

    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 13, tcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, tcfg.vocab, (B, 13)).astype(np.int32)
    mask = rng.random((B, 13)) < 0.8
    for m in (None, mask):
        want = jlm.chunked_ce(jparams, jcfg, jnp.asarray(x), jnp.asarray(tgt),
                              None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = lm.chunked_ce(params, tcfg, torch.from_numpy(x),
                                torch.from_numpy(tgt),
                                None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """``remat=True`` (each layer group under ``torch.utils.checkpoint``)
    recomputes the same activations: the same loss and gradients, bit for
    bit on the CPU, and the MoE's aux through the checkpoint."""
    tcfg = configs.get_reduced(arch)
    _, tb = _batch(tcfg)
    out = []
    for remat in (False, True):
        params = lm.init_params(tcfg, seed=2, device="cpu")
        params.requires_grad_(True)
        loss = lm.loss_fn(params, tcfg, tb, remat=remat)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    params.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_serving_stays_without_grad():
    """``step`` and ``init_params`` run under no_grad: serving builds no
    graph, even on parameters that require grad."""
    tcfg = configs.get_reduced("granite-8b")
    params = lm.init_params(tcfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    params.requires_grad_(True)
    cache = lm.init_cache(params, tcfg, 1, 8, device="cpu")
    logits, _ = lm.step(params, tcfg, cache, torch.zeros((1, 4),
                                                         dtype=torch.int32))
    assert not logits.requires_grad


def test_train_cli_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train`` with ``--device cpu``: the
    reference's lines, a loss that falls on the learnable data."""
    train.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                "--steps", "30", "--batch", "2", "--seq", "32",
                "--log-every", "10"])
    out = capsys.readouterr().out
    assert out.startswith("train: granite-8b-reduced params~")
    assert "step    29 loss" in out
    assert "done: loss" in out and "LEARNED" in out


def test_train_without_a_card_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(configs.get_reduced("granite-8b"), steps=1, batch=1,
                    seq=4)


def test_depth_cut_config_trains():
    """The card's train phase cuts granite-8b in depth with
    ``dataclasses.replace``; the same cut at the reduced width trains."""
    cfg = dataclasses.replace(configs.get_reduced("granite-8b"), n_layers=1,
                              name="granite-8b-reduced at 1 layer")
    run = train.train(cfg, steps=3, batch=2, seq=16, device="cpu",
                      log_every=10)
    assert len(run.losses) == 3 and len(run.params.layers) == 1
    assert all(np.isfinite(run.losses + run.grad_norms))
