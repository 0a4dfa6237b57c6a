"""The port's MoE layer and the reduced granite-moe-3b-a800m and
arctic-480b against the JAX package, on the CPU.

As in ``tests/test_torch_model.py``: the JAX package's own weights are
carried across with ``convert.from_jax_params``, the same numpy inputs go
to both sides, and decoding is teacher-forced.

Routing.  Top-k routing is discontinuous: where the k-th and (k+1)-th
router probabilities of a token nearly tie, a rounding difference between
the frameworks can swap those experts, and that token's FFN output then
changes by O(1).  So routing is compared exactly, except for tokens whose
JAX margin (k-th minus (k+1)-th probability) lies below a threshold:

- the layer test feeds both sides identical inputs, whose f32 router
  logits differ only by the order of f32 sums (the probabilities by
  ~3e-8): threshold 1e-5;
- the model tests feed each side's MoE its own hidden state, which
  differs from the other's by bf16 roundings (~2**-8 relative per
  element); through the reduced router (d=64, std 0.02) that moves a
  probability by at most ~6e-4: threshold 1e-3.

The model tests record the routing of every MoE layer on both sides (the
JAX side through ``jax.debug.callback`` around ``moe_apply``, inside its
jitted step).  Every token routed differently must lie below the
threshold, until its batch row holds such a token: the hidden states of
that row then differ by more than roundings, in later layers and, through
the attention cache, at later steps.  The last position's logits are held
to atol 2e-2, as for granite; a batch row may exceed it only once one of
its tokens, at this step or an earlier one, was routed differently.

Other tolerances: the layer's y in bf16 at rtol 2e-2 and atol 2e-2 times
the output's scale (expert outputs reach O(10): the expert stacks are
drawn at std 1/sqrt(E), the JAX package's fan-in); in f32 at rtol 1e-4
and atol 1e-4 times the scale (f32 sums over d and f in another order).
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
from repro.model import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import convert, lm, moe  # noqa: E402

ATOL = 2e-2
LAYER_MARGIN = 1e-5
MODEL_MARGIN = 1e-3
Y_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
B, PROMPT, STEPS = 2, 24, 9
ARCHS = ["granite-moe-3b-a800m", "arctic-480b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_topk(probs, k):
    """JAX's top-k expert sets and margins, from its probabilities."""
    top_i = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])
    srt = -np.sort(-probs, axis=-1)
    return top_i, srt[:, k - 1] - srt[:, k]


def _differ(a, b):
    """Per token: do the two (T, k) top-k index arrays pick other sets?"""
    return np.array([set(x) != set(y) for x, y in zip(a, b, strict=True)])


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer(arch, dtype):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(3))
    layer = moe.MoE(tcfg, "cpu")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(_np(jp[name]))))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        layer.to(torch.float32)
    x = np.random.default_rng(2).standard_normal(
        (B, 16, tcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, tcfg, jp, layer, jx, tx


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_moe_apply(arch, dtype):
    jcfg, tcfg, jp, layer, jx, tx = _layer(arch, dtype)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    with torch.no_grad():
        y, aux = layer(tx, tcfg)
        probs, _, top_i = moe.route(layer.router, tcfg,
                                    tx.reshape(-1, tcfg.d_model))
    jprobs = jax.nn.softmax(
        jx.reshape(-1, jcfg.d_model).astype(jnp.float32) @ jp["router"], -1)
    jtop, margin = _jax_topk(np.asarray(jprobs), tcfg.top_k)
    differ = _differ(top_i.numpy(), jtop)
    assert (margin[differ] < LAYER_MARGIN).all(), margin[differ]

    assert y.dtype == tx.dtype and tuple(y.shape) == tuple(jy.shape)
    got, want = _np(y).reshape(-1, tcfg.d_model), _np(jy).reshape(
        -1, tcfg.d_model)
    scale = float(np.abs(want).max())
    assert scale > 1.0                       # the expert outputs are large
    tol = Y_TOL[dtype]
    np.testing.assert_allclose(got[~differ], want[~differ], rtol=tol,
                               atol=tol * scale)
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), rtol=0,
                               atol=1e-6)
    if not differ.any():
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_aux_loss_is_the_switch_loss():
    probs = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6]])
    top_i = torch.tensor([[0, 1], [2, 1]])
    # fractions routed (1/2, 1, 1/2), mean probabilities (0.4, 0.25, 0.35)
    want = 3 * (0.5 * 0.4 + 1.0 * 0.25 + 0.5 * 0.35)
    aux = moe.aux_loss(probs, top_i, 3, torch.float32)
    assert aux.dtype == torch.float32
    torch.testing.assert_close(aux, torch.tensor(want))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree(arch, seed):
    jcfg = jconfigs.get_reduced(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams)


def _models(arch, seed=0):
    jcfg, jparams, tree = _tree(arch, seed)
    tcfg = configs.get_reduced(arch)
    return jcfg, jparams, tcfg, convert.from_jax_params(tree, tcfg,
                                                         device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_moe_leaf(arch):
    """The names match (``layers.N.moe.router``), so convert needs no MoE
    case: every leaf arrives with its layout and dtype, the router in f32
    and the expert stacks in bf16, and arctic's dense residual MLP too."""
    jcfg, jparams, tcfg, params = _models(arch)
    port = dict(params.named_parameters())
    for n in range(tcfg.n_layers):
        g = jparams["groups"][0]
        for name, leaf in g["moe"].items():
            p = port[f"layers.{n}.moe.{name}"]
            assert p.dtype == (torch.float32 if name == "router"
                               else torch.bfloat16)
            np.testing.assert_array_equal(_np(p), _np(leaf[n]))
        assert (f"layers.{n}.mlp.w_up" in port) == tcfg.dense_residual
    assert tuple(port["layers.0.moe.w_down"].shape) == (
        tcfg.n_experts, tcfg.moe_d_ff, tcfg.d_model)
    n_leaves = len(jax.tree_util.tree_leaves(jparams))
    n_groups = tcfg.n_layers // len(tcfg.layer_pattern)
    n_stacked = len(jax.tree_util.tree_leaves(jparams["groups"]))
    assert len(port) == n_leaves + n_stacked * (n_groups - 1)


def _record_jax_probs(monkeypatch):
    """Router probabilities of every ``moe_apply`` call, sent out of the
    jitted JAX step in call order."""
    record = []
    inner = jmoe.moe_apply

    def recording(p, cfg, x):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xf @ p["router"], axis=-1)
        jax.debug.callback(lambda a: record.append(np.asarray(a)), probs,
                           ordered=True)
        return inner(p, cfg, x)

    monkeypatch.setattr(jmoe, "moe_apply", recording)
    return record


def _record_port_topk(params, cfg):
    """Top-k experts of every MoE layer of the port, in call order, and the
    hook handles."""
    record = []

    def hook(module, args, out):
        x = args[0]
        with torch.no_grad():
            _, _, top_i = moe.route(module.router, cfg,
                                    x.reshape(-1, x.shape[-1]))
        record.append(top_i.numpy())

    return record, [layer.moe.register_forward_hook(hook)
                    for layer in params.layers]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch, seed, monkeypatch):
    jrecord = _record_jax_probs(monkeypatch)
    jcfg, jparams, tcfg, params = _models(arch, seed)
    trecord, handles = _record_port_topk(params, tcfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab, (B, PROMPT + STEPS), dtype=np.int32)
    max_seq = PROMPT + STEPS + 1

    jstep = jax.jit(lambda p, c, t: jlm.step(p, jcfg, c, t))
    jcache = jlm.init_cache(jparams, jcfg, B, max_seq=max_seq)
    cache = lm.init_cache(params, tcfg, B, max_seq=max_seq, device="cpu")
    feeds = [tokens[:, :PROMPT]] + [tokens[:, PROMPT + i:PROMPT + i + 1]
                                    for i in range(STEPS)]
    rerouted = np.zeros(B, bool)        # rows with a token routed otherwise
    excess = 0
    try:
        for t in feeds:
            jrecord.clear()
            trecord.clear()
            jlogits, jcache = jstep(jparams, jcache, jnp.asarray(t))
            want = _np(jlogits)
            jax.effects_barrier()
            logits, cache = lm.step(params, tcfg, cache, torch.from_numpy(t))
            got = _np(logits)
            assert len(jrecord) == len(trecord) == tcfg.n_layers
            for jprobs, top_i in zip(jrecord, trecord, strict=True):
                jtop, margin = _jax_topk(jprobs, tcfg.top_k)
                differ = _differ(top_i, jtop).reshape(B, -1)
                # in a row already rerouted the hidden states differ by
                # more than roundings, so routing may differ anywhere
                first = differ & ~rerouted[:, None]
                near = margin.reshape(B, -1)[first]
                assert (near < MODEL_MARGIN).all(), near
                rerouted |= differ.any(1)
            assert got.shape == (B, tcfg.vocab_padded)
            over = np.abs(got - want).max(-1) > ATOL
            assert not (over & ~rerouted).any(), (
                np.abs(got - want).max(-1), rerouted)
            excess += int(over.sum())
            assert cache["pos"] == int(jcache["pos"])
    finally:
        for h in handles:
            h.remove()
    assert cache["pos"] == PROMPT + STEPS
    # a near-tie moves a few rows' logits, never most of them
    assert excess <= B * len(feeds) // 4, excess


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_of_prompt_plus_one_matches_first_decode_step(arch):
    """The port's own cache consistency, with the weights widened to f32:
    the prefill and decode paths differ only by the order of sums."""
    tcfg = configs.get_reduced(arch)
    params = lm.init_params(tcfg, seed=4, device="cpu").to(torch.float32)
    prompts = serve.make_prompts(tcfg, B, PROMPT, "cpu")
    res = serve.generate(params, tcfg, prompts, 1)
    assert res.logits.dtype == torch.float32
    again = serve.generate(params, tcfg,
                           torch.cat([prompts, res.tokens[:, :1]], 1), 0)
    torch.testing.assert_close(again.logits[0], res.logits[1], rtol=1e-5,
                               atol=1e-5)
