"""The port's zamba2-7b-reduced and rwkv6-reduced against the JAX
package's, on the CPU.

As in ``tests/test_torch_model.py``: the JAX package's own
``lm.init_params(PRNGKey(0))`` weights are carried across with
``convert.from_jax_params``, the same numpy token ids go to
``repro.model.lm.step`` (under its default "ref" kernels) and to the
port's ``lm.step``, and decoding is teacher-forced.

Tolerances:
- logits: atol 2e-2 on bf16 logits of magnitude ~0.5, as for granite;
- the caches after the prefill: atol 2e-2 plus one bf16 step of the value
  (rtol 2**-7) on the first layer's, whose inputs differ between the
  frameworks only by the rounding of one projection; on every layer's, where
  bf16 rounding compounds with depth, the relative L2 error of 5e-2 that
  ``chip_smoke.py`` allows bf16 logits;
- the port's own cache consistency in f32 (prefill of prompt + 1 against
  the first decode step): 1e-5, since only the order of sums differs.
"""
import functools

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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402

ATOL = 2e-2
CACHE_TOL = dict(rtol=2 ** -7, atol=ATOL)
CACHE_REL_L2 = 5e-2
B, PROMPT, STEPS = 2, 24, 9
ARCHS = ["zamba2-7b", "rwkv6-1.6b"]
#: the recurrent caches of each layer kind, by their JAX names
STATES = {"M": ("conv", "ssd"), "R": ("tm_shift", "cm_shift", "wkv")}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    return jcfg, jparams, tcfg, convert.from_jax_params(tree, tcfg,
                                                         device="cpu")


def _jax_leaves(jparams, cfg):
    """(port name, JAX leaf) for every leaf of the JAX tree."""
    P = len(cfg.layer_pattern)
    rest = {k: v for k, v in jparams.items() if k != "groups"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rest)[0]:
        yield ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path), leaf
    for i, group in enumerate(jparams["groups"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(group)[0]:
            name = ".".join(str(k.key) for k in path)
            for n in range(leaf.shape[0]):
                yield f"layers.{n * P + i}.{name}", leaf[n]


def test_convert_carries_every_zamba2_leaf_with_its_layout_and_dtype():
    jcfg, jparams, tcfg, params = _models("zamba2-7b")
    port = dict(params.named_parameters())
    names = set()
    for name, leaf in _jax_leaves(jparams, jcfg):
        p = port[name]
        assert tuple(p.shape) == leaf.shape, name
        assert p.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                           jnp.dtype(jnp.float32): torch.float32}[leaf.dtype]
        np.testing.assert_array_equal(_np(p), _np(leaf), err_msg=name)
        names.add(name)
    assert names == set(port)
    assert {"shared.1.attn.wq", "shared.0.mlp.w_gate", "layers.5.w_shared_in",
            "layers.4.mamba.conv_w", "layers.5.mamba.A_log"} <= names


def test_convert_carries_every_rwkv6_leaf_with_its_layout_and_dtype():
    jcfg, jparams, tcfg, params = _models("rwkv6-1.6b")
    port = dict(params.named_parameters())
    names = {name for name, _ in _jax_leaves(jparams, jcfg)}
    assert names == set(port)
    tm = params.layers[1].rwkv.time_mix
    assert tm.u.dtype == tm.w_base.dtype == torch.float32
    assert tm.mu.dtype == tm.w_A.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(tm.w_B), _np(jparams["groups"][0]["rwkv"]["time_mix"]["w_B"][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch):
    jcfg, jparams, tcfg, params = _models(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, (B, PROMPT + STEPS), dtype=np.int32)
    max_seq = PROMPT + STEPS + 1

    jstep = jax.jit(lambda p, c, t: jlm.step(p, jcfg, c, t))
    jcache = jlm.init_cache(jparams, jcfg, B, max_seq=max_seq)
    cache = lm.init_cache(params, tcfg, B, max_seq=max_seq, device="cpu")
    feeds = [tokens[:, :PROMPT]] + [tokens[:, PROMPT + i:PROMPT + i + 1]
                                    for i in range(STEPS)]
    for t in feeds:
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(t))
        logits, cache = lm.step(params, tcfg, cache, torch.from_numpy(t))
        want, got = _np(jlogits), _np(logits)
        assert got.shape == (B, tcfg.vocab_padded)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert cache["pos"] == int(jcache["pos"])
    assert cache["pos"] == PROMPT + STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_states_match_jax_cache(arch):
    """After the prefill, every layer's conv and ssd (mamba2) or
    token-shift and wkv (rwkv6) states hold what the JAX package's cache
    holds, in its shapes and dtypes: layer 0's elementwise, the deeper
    ones, where bf16 rounding compounds, to a relative L2 error."""
    jcfg, jparams, tcfg, params = _models(arch)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (B, 13),
                                               dtype=np.int32)
    _, jcache = jlm.step(jparams, jcfg,
                         jlm.init_cache(jparams, jcfg, B, max_seq=16),
                         jnp.asarray(tokens))
    _, cache = lm.step(params, tcfg,
                       lm.init_cache(params, tcfg, B, 16, device="cpu"),
                       torch.from_numpy(tokens))
    P = len(tcfg.layer_pattern)
    for i, layer_cache in enumerate(cache["layers"]):
        kind = tcfg.layer_pattern[i % P]
        jc = jcache["groups"][i % P]
        if kind == "H":
            layer_cache, jc = layer_cache["mamba"], jc["mamba"]
            assert tuple(cache["layers"][i]["attn"]["k"].shape) == \
                jcache["groups"][i % P]["attn"]["k"].shape[1:]
        for name in STATES["R" if kind == "R" else "M"]:
            got, want = layer_cache[name], jc[name][i // P]
            assert tuple(got.shape) == want.shape, name
            assert got.dtype == {
                jnp.dtype(jnp.bfloat16): torch.bfloat16,
                jnp.dtype(jnp.float32): torch.float32}[want.dtype], name
            g, w = _np(got), _np(want)
            if i == 0:
                np.testing.assert_allclose(g, w, **CACHE_TOL, err_msg=name)
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= CACHE_REL_L2, (i, name, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_of_prompt_plus_one_matches_first_decode_step(arch):
    """The carried states (conv, ssd, token shifts, wkv, and zamba2's
    attention caches) give the first decode step what a prefill of the
    prompt and that token gives, with the weights widened to f32."""
    tcfg = configs.get_reduced(arch)
    params = lm.init_params(tcfg, seed=4, device="cpu").to(torch.float32)
    prompts = serve.make_prompts(tcfg, B, PROMPT, "cpu")
    res = serve.generate(params, tcfg, prompts, 1)
    assert res.logits.dtype == torch.float32
    again = serve.generate(params, tcfg,
                           torch.cat([prompts, res.tokens[:, :1]], 1), 0)
    torch.testing.assert_close(again.logits[0], res.logits[1], rtol=1e-5,
                               atol=1e-5)
