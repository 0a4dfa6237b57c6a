"""The port's granite-8b-reduced against the JAX package's, on the CPU.

The JAX package's own ``lm.init_params(PRNGKey(0))`` weights are carried
across with ``convert.from_jax_params``; the same numpy token ids go to
``repro.model.lm.step`` (under its default "ref" kernels) and to the
port's ``lm.step``.  Decoding is teacher-forced: both sides are fed the
same tokens.  Free-running greedy decoding is not compared token by token,
because at this size the random weights leave near-ties between the top two
logits that one bf16 rounding can flip; greedy tokens are compared only
where JAX's top-1/top-2 margin exceeds twice the tolerance.

Tolerance: atol 2e-2 on bf16 logits of magnitude ~0.5 (the two frameworks
round bf16 matmuls and elementwise ops at different places).
"""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402

ATOL = 2e-2
B, PROMPT, STEPS = 2, 24, 9

#: (layer pattern, sliding window): all global; a local layer whose ring
#: is filled by the prefill (prompt >= window); one the prefill does not
#: fill but decoding wraps (max_seq > window > prompt)
VARIANTS = {"global": ("G", None), "ring-fill": ("LG", 8),
            "ring-wrap": ("LG", 28)}


def _configs(variant):
    pattern, window = VARIANTS[variant]
    kw = dict(layer_pattern=pattern, sliding_window=window)
    return (dataclasses.replace(jconfigs.get_reduced("granite-8b"), **kw),
            dataclasses.replace(configs.get_reduced("granite-8b"), **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(variant):
    jcfg, tcfg = _configs(variant)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    return jcfg, jparams, tcfg, convert.from_jax_params(tree, tcfg, device="cpu")


def test_convert_keeps_values_layouts_and_dtypes():
    jcfg, jparams, tcfg, params = _models("ring-fill")
    assert params.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(params.embed), _np(jparams["embed"]))
    for n, layer in enumerate(params.layers):
        g = jparams["groups"][n % 2]      # pattern "LG": two positions
        assert layer.ln_attn.w.dtype == torch.float32
        np.testing.assert_array_equal(_np(layer.attn.wq),
                                      _np(g["attn"]["wq"][n // 2]))
        np.testing.assert_array_equal(_np(layer.mlp.w_gate),
                                      _np(g["mlp"]["w_gate"][n // 2]))
    assert tuple(params.layers[0].attn.wo.shape) == (tcfg.q_dim,
                                                     tcfg.d_model)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_teacher_forced_logits_match_jax(variant):
    jcfg, jparams, tcfg, params = _models(variant)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, (B, PROMPT + STEPS), dtype=np.int32)
    max_seq = PROMPT + STEPS + 1

    jstep = jax.jit(lambda p, c, t: jlm.step(p, jcfg, c, t))
    jcache = jlm.init_cache(jparams, jcfg, B, max_seq=max_seq)
    cache = lm.init_cache(params, tcfg, B, max_seq=max_seq, device="cpu")
    feeds = [tokens[:, :PROMPT]] + [tokens[:, PROMPT + i:PROMPT + i + 1]
                                    for i in range(STEPS)]
    margin_ok = 0
    for t in feeds:
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(t))
        logits, cache = lm.step(params, tcfg, cache, torch.from_numpy(t))
        want, got = _np(jlogits), _np(logits)
        assert got.shape == (B, tcfg.vocab_padded)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert cache["pos"] == int(jcache["pos"])
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * ATOL
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        margin_ok += int(clear.sum())
    assert cache["pos"] == PROMPT + STEPS
    assert margin_ok > 0


def test_prefill_ring_matches_jax_cache():
    """After a prefill longer than the window, the local layer's cache
    holds the last W keys ring-aligned, as in the JAX package.  Layer 0 is
    the local one, so its keys differ between the frameworks only by the
    rounding of one projection."""
    jcfg, jparams, tcfg, params = _models("ring-fill")
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (B, 13),
                                               dtype=np.int32)
    _, jcache = jlm.step(jparams, jcfg,
                         jlm.init_cache(jparams, jcfg, B, max_seq=16),
                         jnp.asarray(tokens))
    _, cache = lm.step(params, tcfg,
                       lm.init_cache(params, tcfg, B, 16, device="cpu"),
                       torch.from_numpy(tokens))
    for name in ("k", "v"):
        want = _np(jcache["groups"][0][name][0])
        got = _np(cache["layers"][0][name])
        assert got.shape == want.shape == (B, 8, tcfg.n_kv_heads,
                                           tcfg.head_dim)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant", ["global", "ring-wrap"])
def test_prefill_of_prompt_plus_one_matches_first_decode_step(variant):
    """The port's own cache consistency, as ``chip_smoke.py`` checks it on
    the card: with the weights widened to f32 (and so an f32 cache) the
    two paths differ only by the order of sums."""
    from repro_torch.launch import serve

    _, tcfg = _configs(variant)
    params = lm.init_params(tcfg, seed=4, device="cpu").to(torch.float32)
    prompts = serve.make_prompts(tcfg, B, PROMPT, "cpu")
    res = serve.generate(params, tcfg, prompts, 1)
    assert res.logits.dtype == torch.float32
    again = serve.generate(params, tcfg,
                           torch.cat([prompts, res.tokens[:, :1]], 1), 0)
    torch.testing.assert_close(again.logits[0], res.logits[1], rtol=1e-5,
                               atol=1e-5)
