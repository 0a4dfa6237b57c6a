"""The port's training substrate against the JAX package's, on the CPU,
case by case as ``tests/test_substrate.py`` holds the reference:
optimizers, clipping and the schedule, the data pipeline, checkpoints, the
fault-tolerant restart of ``repro_torch.launch.train``, and elastic
replanning.

Tolerances: the optimizers' f32 updates agree to 1e-6 relative (the same
f32 ops; ``b1 ** step`` and the means of Adafactor's factored moment may
round one ulp apart), their bf16 parameters bit for bit; the schedule, the
batches, a checkpoint's round trip and every plan exactly.
"""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ckpt import restore_checkpoint as j_restore  # noqa: E402
from repro.ckpt import save_checkpoint as j_save  # noqa: E402
from repro.data import MemmapTokens as JMemmap  # noqa: E402
from repro.data import SyntheticTokens as JSynthetic  # noqa: E402
from repro.distributed.elastic import ClusterState as JClusterState  # noqa: E402
from repro.distributed.elastic import replan as j_replan  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.ckpt import (latest_step, restore_checkpoint,  # noqa: E402
                              save_checkpoint)
from repro_torch.data import (MemmapTokens, ShardedLoader,  # noqa: E402
                              SyntheticTokens)
from repro_torch.distributed.elastic import ClusterState, replan  # noqa: E402
from _torch_sim import port_obs_isolation  # noqa: E402

assert port_obs_isolation  # the autouse fixture, imported to apply here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a tree of the leaf shapes the optimizers see: a matrix, a vector, a
#: stack of matrices (the MoE experts), and a bf16 matrix
SHAPES = {"w": (8, 16), "b": (16,), "stack": (3, 4, 5), "h": (6, 7)}
BF16 = {"h"}


def _jax(a, k):
    return jnp.asarray(a, jnp.bfloat16 if k in BF16 else jnp.float32)


def _torch(a, k):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if k in BF16 else torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, k):
    if k in BF16:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_match_reference_updates(opt):
    """Six steps on random gradients: parameters, state and step count."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    j_init, j_update = (getattr(joptim, f"{opt}_init"),
                        getattr(joptim, f"{opt}_update"))
    t_init, t_update = (getattr(optim, f"{opt}_init"),
                        getattr(optim, f"{opt}_update"))
    jp = {k: _jax(v, k) for k, v in p0.items()}
    tp = {k: _torch(v, k) for k, v in p0.items()}
    js, ts = j_init(jp), t_init(tp)
    for _ in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, js = j_update(jp, {k: _jax(v, k) for k, v in g.items()}, js,
                          lr=1e-2)
        tp, ts = t_update(tp, {k: _torch(v, k) for k, v in g.items()}, ts,
                          lr=1e-2)
    assert int(ts["step"]) == int(js["step"]) == 6
    assert ts["step"].dtype == torch.int32
    for k in SHAPES:
        assert tp[k].dtype == (torch.bfloat16 if k in BF16
                               else torch.float32)
        _close(tp[k], jp[k], k)
        moments = ({"m": ts["m"][k], "v": ts["v"][k]} if opt == "adamw"
                   else ts["v"][k])
        want = ({"m": js["m"][k], "v": js["v"][k]} if opt == "adamw"
                else js["v"][k])
        assert set(moments) == set(want)
        for name, m in moments.items():
            assert m.dtype == torch.float32
            np.testing.assert_allclose(_np(m), _np(want[name]), rtol=1e-6,
                                       atol=0)


def test_optimizers_take_named_parameters():
    """``named_parameters()`` pairs work as the dict does, in place."""
    lin = torch.nn.Linear(4, 3)
    state = optim.adamw_init(lin.named_parameters())
    before = lin.weight.detach().clone()
    grads = {n: torch.ones_like(p) for n, p in lin.named_parameters()}
    params, state = optim.adamw_update(lin.named_parameters(), grads, state,
                                       lr=0.1)
    assert params["weight"] is lin.weight
    assert not torch.equal(lin.weight.detach(), before)
    assert int(state["step"]) == 1


def _quad_problem():
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8)), "b": torch.zeros((8,))}

    def loss(p):
        return torch.sum((p["w"] + p["b"][None, :] - target) ** 2)
    return params, loss


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_descend(opt):
    params, loss = _quad_problem()
    init, update = getattr(optim, f"{opt}_init"), getattr(optim,
                                                          f"{opt}_update")
    state = init(params)
    l0 = float(loss(params))
    for _ in range(150):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, state = update(params, g, state, lr=5e-2)
    assert float(loss(params)) < 0.05 * l0


def test_clip_matches_reference():
    rng = np.random.default_rng(3)
    g = {k: rng.standard_normal(s).astype(np.float32) * 3
         for k, s in SHAPES.items()}
    for max_norm in (1.0, 1e3):
        jc, jn = joptim.clip_by_global_norm(
            {k: _jax(v, k) for k, v in g.items()}, max_norm)
        tc, tn = optim.clip_by_global_norm(
            {k: _torch(v, k) for k, v in g.items()}, max_norm)
        assert tn.dtype == torch.float32
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in SHAPES:
            assert tc[k].dtype == _torch(g[k], k).dtype
            _close(tc[k], jc[k], k)
    # tests/test_substrate.py's case
    clipped, gn = optim.clip_by_global_norm({"a": torch.full((4,), 10.0)},
                                            1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-3)


@pytest.mark.parametrize("peak,warmup,total", [
    (1.0, 10, 100), (3e-3, 20, 200), (3e-3, 20, 60), (3e-3, 20, 5),
    (1e-4, 0, 1000), (0.1, 100, 2000)])
def test_cosine_schedule_equals_reference_exactly(peak, warmup, total):
    for step in range(total + 30):
        want = float(np.float32(joptim.cosine_schedule(
            step, peak=peak, warmup=warmup, total=total)))
        assert optim.cosine_schedule(step, peak=peak, warmup=warmup,
                                     total=total) == want, step
    lrs = [optim.cosine_schedule(s, peak=1.0, warmup=10, total=100)
           for s in (0, 10, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(1.0) \
        and lrs[2] == pytest.approx(0.1, rel=1e-2)


@pytest.mark.parametrize("vocab,seed", [(512, 0), (49152, 0), (256, 7)])
def test_synthetic_batches_equal_the_reference(vocab, seed):
    src, ref = SyntheticTokens(vocab, seed=seed), JSynthetic(vocab, seed=seed)
    for step, shard, batch, seq in ((0, 0, 4, 32), (5, 1, 2, 33),
                                    (123, 3, 1, 128)):
        got = src.batch(step, shard, batch, seq)
        want = ref.batch(step, shard, batch, seq)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    b0 = src.batch(0, shard=0, batch=4, seq=32)
    assert not np.array_equal(b0, src.batch(0, shard=1, batch=4, seq=32))
    half = 33 // 2
    np.testing.assert_array_equal(b0[:, half:2 * half], b0[:, :half])


def test_memmap_batches_equal_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(2).integers(0, 1000, 5000).astype(
        np.uint16).tofile(path)
    got, want = MemmapTokens(str(path), 1000), JMemmap(str(path), 1000)
    for step in range(3):
        np.testing.assert_array_equal(got.batch(step, 1, 4, 64),
                                      want.batch(step, 1, 4, 64))


@pytest.mark.parametrize("start", [0, 7])
def test_loader_reads_the_steps_in_order(start):
    src = SyntheticTokens(512, seed=1)
    loader = ShardedLoader(src, shard=2, batch=3, seq=16, start=start)
    try:
        for step in range(start, start + 4):
            np.testing.assert_array_equal(next(loader),
                                          src.batch(step, 2, 3, 16))
    finally:
        loader.close()


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "layers.0.attn.wq": torch.linspace(
                           -3, 3, 20).reshape(4, 5).to(torch.bfloat16)},
            "opt": {"m": {"w": torch.ones((3, 4))},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    t = save_checkpoint(str(tmp_path), 9, tree, asynchronous=True)
    t.join(timeout=60)
    assert not t.is_alive()
    assert latest_step(str(tmp_path)) == 9
    assert latest_step(str(tmp_path / "none")) is None
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in tree["params"].items()},
                "opt": {"m": {"w": torch.zeros((3, 4))},
                        "step": torch.zeros((), dtype=torch.int32)}}
    back = restore_checkpoint(str(tmp_path), 9, template)
    for k, v in tree["params"].items():
        assert back["params"][k].dtype == v.dtype
        assert torch.equal(back["params"][k], v)
    assert int(back["opt"]["step"]) == 7
    assert back["opt"]["step"].dtype == torch.int32
    # the leaves were copied when save returned
    tree["params"]["w"].add_(1)
    again = restore_checkpoint(str(tmp_path), 5, template)
    assert torch.equal(again["params"]["w"], torch.arange(12.0).reshape(3,
                                                                        4))


def test_checkpoint_layout_is_the_references(tmp_path):
    """The reference restores the port's checkpoint and the port the
    reference's: the same files, keys and f32 storage of bf16."""
    tree = _tree()
    save_checkpoint(str(tmp_path / "port"), 3, tree)
    d = tmp_path / "port" / "step_00000003"
    assert sorted(os.listdir(d)) == ["manifest.json", "shard_0.npz"]
    with np.load(d / "shard_0.npz") as z:
        assert sorted(z.files) == sorted(
            ["params|w", "params|layers.0.attn.wq", "opt|m|w", "opt|step"])
        assert z["params|layers.0.attn.wq"].dtype == np.float32
    jtree = jax.tree.map(lambda t: jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else
        jnp.int32 if t.dtype == torch.int32 else jnp.float32), tree)
    back = j_restore(str(tmp_path / "port"), 3, jtree)
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(_np(back["params"][k]), _np(v))
    j_save(str(tmp_path / "ref"), 4, jtree)
    mine = restore_checkpoint(str(tmp_path / "ref"), 4, tree)
    for k, v in tree["params"].items():
        assert mine["params"][k].dtype == v.dtype
        assert torch.equal(mine["params"][k], v)
    assert int(mine["opt"]["step"]) == 7


def _train(args, env):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--reduced", "--device", "cpu", "--steps", "60",
         "--batch", "2", "--seq", "32", "--ckpt-every", "20",
         "--log-every", "1", *args], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)


def _losses(out):
    return {int(m.group(1)): (m.group(2), m.group(3)) for m in re.finditer(
        r"^step +(\d+) loss (\S+) gnorm (\S+)", out, re.M)}


def test_train_restart_after_failure(tmp_path):
    """``tests/test_substrate.py``'s FT restart on the port, on the CPU:
    crash at step 30, restart from the checkpoint of step 20.  The resumed
    run's logged losses and grad norms and its final checkpoint equal an
    unbroken run's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    broken, whole = str(tmp_path / "broken"), str(tmp_path / "whole")
    r = _train(["--ckpt-dir", broken, "--fail-at", "30"], env)
    assert r.returncode == 42, r.stderr[-2000:]
    assert "simulated failure at step 30" in r.stdout
    assert latest_step(broken) == 20
    r = _train(["--ckpt-dir", broken], env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restoring from step 20" in r.stdout
    assert latest_step(broken) == 60
    resumed = _losses(r.stdout)
    assert sorted(resumed) == list(range(20, 60))
    r = _train(["--ckpt-dir", whole], env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert re.search(r"^done: loss \S+ -> \S+ \((LEARNED|flat)\)$",
                     r.stdout, re.M)
    unbroken = _losses(r.stdout)
    assert {s: unbroken[s] for s in resumed} == resumed
    with np.load(os.path.join(broken, "step_00000060", "shard_0.npz")) as a, \
            np.load(os.path.join(whole, "step_00000060", "shard_0.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


#: the replans of tests/test_substrate.py (``test_elastic_replan_on_failure``
#: and ``test_straggler_derate``): healthy, a failed slot, a straggler
REPLANS = {
    "healthy": dict(pods=2, data=16, model=16),
    "failed-slot": dict(pods=2, data=16, model=16,
                        failed_slots=frozenset({(1, 3)})),
    "straggler": dict(pods=1, data=16, model=16, derate={(0, 0): 0.4}),
}


@pytest.mark.parametrize("case", list(REPLANS))
def test_replan_equals_reference(case):
    want = j_replan(jconfigs.get("granite-8b"), "train_4k",
                    JClusterState(**REPLANS[case]))
    got = replan(configs.get("granite-8b"), "train_4k",
                 ClusterState(**REPLANS[case]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_stages >= 1
    if case == "failed-slot":
        assert (1, 3) not in got.stage_slots
