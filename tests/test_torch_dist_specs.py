"""The distributed runtime's layout functions against the JAX package's,
with no process group: ``pipeline.param_specs``, ``optim.zero1_specs``,
``baseline.cache_shardings``, ``sharding.refined_layout`` (the rank layout
of ``refined_mesh``) and the int8 error-feedback compression.

The JAX side runs once, in one subprocess with 64 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=64``, as
``tests/test_distributed.py`` runs its 8), and prints its results as
JSON.  Placements compare exactly, leaf by leaf: the reference's stacked
leaves lose their stack dims ((G,) in the baseline layout, (S, Gs) in the
pipeline's), since the port holds one tensor a layer.  The compression
compares bit for bit.
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

import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import baseline, collectives  # noqa: E402
from repro_torch.distributed import pipeline, sharding  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.model import lm  # noqa: E402
from repro_torch.optim import zero1_specs  # noqa: E402
from _torch_sim import port_obs_isolation  # noqa: E402

assert port_obs_isolation  # the autouse fixture, imported to apply here

ARCHS = list(jconfigs.ARCHS)
TPS = (4, 16)
#: the cache's batch and length (full-size configs, shapes only)
CACHE_B, CACHE_SEQ = 8, 4096
CACHE_MESH = {"data": 4, "model": 16}
#: the refined layouts compared: plan_cell's plans (granite-8b's on (2, 4,
#: 8), where zamba2-7b's and arctic-480b's are infeasible, and all three on
#: (2, 8, 8)) and plans written out for the rules plan_cell's do not reach
#: (free slots shared evenly; uneven ones, then uniform slabs)
PLAN_CASES = {
    "granite-8b/248": ((2, 4, 8), "granite-8b"),
    "granite-8b/288": ((2, 8, 8), "granite-8b"),
    "zamba2-7b/288": ((2, 8, 8), "zamba2-7b"),
    "arctic-480b/288": ((2, 8, 8), "arctic-480b"),
    "even-free": ((2, 4, 8), dict(n_stages=2, stage_slots=[(0, 0), (1, 2)],
                                  boundary_depth=[2], tp=2)),
    "four-stages": ((2, 4, 8), dict(n_stages=4, stage_slots=[
        (0, 0), (0, 1), (1, 1), (1, 0)], boundary_depth=[1, 2, 1], tp=2)),
    "uneven-slabs": ((2, 4, 8), dict(n_stages=4, stage_slots=[
        (0, 0), (0, 1), (0, 2), (0, 2)], boundary_depth=[1, 1, 1], tp=2)),
    "uneven-unfit": ((2, 4, 8), dict(n_stages=3, stage_slots=[
        (0, 0), (0, 1), (0, 2)], boundary_depth=[1, 1], tp=2)),
    "2d": ((4, 8), dict(n_stages=2, stage_slots=[(0, 0), (0, 3)],
                        boundary_depth=[1], tp=2)),
}
#: zero1 inputs: (spec, shape, data size)
ZERO1_CASES = [
    ((None, "model"), (4096, 14336), 16),
    (("model", None), (49152, 4096), 16),
    ((None, None, "model"), (40, 1536, 512), 8),
    ((None,), (4096,), 16),
    ((None,), (100,), 16),
    ((), (), 4),
    ((None, None), (96, 96), 4),
    (("model", None, None), (128, 7168, 4864), 2),
    ((None, "model", None), (6, 7, 5), 3),
]
INT8_SHAPES = {"a": (37, 5), "b": (128,), "c": (3, 4, 8)}
INT8_STEPS = 3

_JAX_SIDE = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import configs
    from repro.model import lm
    from repro.distributed import pipeline as pp, baseline as bl
    from repro.distributed import collectives as co
    from repro.distributed.sharding import TpuPlan, refined_mesh, plan_cell
    from repro.launch.mesh import make_mesh
    from repro.optim import zero1_specs

    args = json.loads(sys.argv[1])
    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]
    def flat(tree, prefix=""):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, (dict, list)):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    isP = lambda x: isinstance(x, P)
    out = {"params": {}, "cache": {}}
    for arch in args["archs"]:
        cfg = configs.get(arch)
        structs = jax.eval_shape(lambda k: lm.init_params(cfg, k),
                                 jax.random.PRNGKey(0))
        G = cfg.n_layers // len(cfg.layer_pattern)
        S = next((s for s in (2, 3, 5, 7) if G % s == 0), 1)
        pstructs = jax.eval_shape(lambda t: pp.to_pipeline_params(t, S),
                                  structs)
        for tp in args["tps"]:
            base = pp.param_specs(cfg, structs, tp_axis="model", tp_size=tp)
            pipe = pp.param_specs(cfg, pstructs, tp_axis="tp", tp_size=tp,
                                  stage_axis="stage")
            out["params"][f"{arch}/{tp}"] = {
                "baseline": {k: spec(v) for k, v in flat(
                    jax.tree.map(lambda x: x, base, is_leaf=isP))},
                "pipeline": {k: spec(v) for k, v in flat(
                    jax.tree.map(lambda x: x, pipe, is_leaf=isP))}}
        mesh = make_mesh((args["cache_mesh"]["data"],
                          args["cache_mesh"]["model"]), ("data", "model"))
        cache = jax.eval_shape(lambda p: lm.init_cache(
            p, cfg, args["cache_b"], max_seq=args["cache_seq"]), structs)
        for kv in ("heads", "context"):
            os.environ["REPRO_KV_SHARD"] = kv
            sh = bl.cache_shardings(cfg, cache, mesh)
            out["cache"][f"{arch}/{kv}"] = {
                k: spec(v.spec) for k, v in flat(sh)}
    out["zero1"] = []
    for sp, shape, data in args["zero1"]:
        z = zero1_specs(P(*sp), jax.ShapeDtypeStruct(tuple(shape),
                        jnp.float32), data_axes=("pod", "data"),
                        data_size=data)
        out["zero1"].append(spec(z))
    ids = lambda m: np.vectorize(lambda d: d.id)(m.devices).tolist()
    out["refined"] = {}
    for name, (shape, how) in args["plans"].items():
        axes = ("pod", "data", "model")[3 - len(shape):]
        devs = make_mesh(tuple(shape), axes)
        if isinstance(how, str):
            plan = plan_cell(configs.get(how), "train_4k", tuple(shape),
                             mode="tapa")
        else:
            how["stage_slots"] = [tuple(x) for x in how["stage_slots"]]
            plan = TpuPlan(mode="tapa", groups_per_stage=1,
                           crossing_cost=0.0, **how)
        try:
            rm = refined_mesh(devs, plan)
            got = {"ids": ids(rm), "axes": list(rm.axis_names)}
        except ValueError as e:
            got = {"error": type(e).__name__}
        out["refined"][name] = dict(got, mesh=ids(devs))
    rng = np.random.default_rng(7)
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10.0 ** i
              for k, s in args["int8"].items()}
             for i in range(args["int8_steps"])]
    err = co.init_error_buf(grads[0])
    out["int8"] = []
    for g in grads:
        q, s, err = co.compress_grads(g, err)
        d = co.decompress_grads(q, s)
        out["int8"].append({k: {"q": np.asarray(q[k]).tolist(),
                                "s": float(s[k]),
                                "e": np.asarray(err[k]).tolist(),
                                "d": np.asarray(d[k]).tolist()}
                            for k in g})
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's layouts and compression, from one subprocess."""
    args = dict(archs=ARCHS, tps=list(TPS), cache_b=CACHE_B,
                cache_seq=CACHE_SEQ, cache_mesh=CACHE_MESH,
                zero1=[[list(s), list(sh), d] for s, sh, d in ZERO1_CASES],
                plans={k: [list(m), h] for k, (m, h) in PLAN_CASES.items()},
                int8={k: list(v) for k, v in INT8_SHAPES.items()},
                int8_steps=INT8_STEPS)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=128")
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, json.dumps(args)],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


def _entry(e):
    """One placement entry as plain data: a tuple of axis names as a list,
    one axis name alone (a mesh axis given as a 1-tuple means that axis:
    the reference's ``NamedSharding`` prints it so)."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else list(e)
    return e


def _plain(spec):
    return [_entry(e) for e in spec]


def _ref_name(name, cfg):
    """The JAX tree's name of one port parameter, and how many stack dims
    its reference leaf has (1 per group in the baseline layout)."""
    parts = name.split(".", 2)
    if parts[0] != "layers":
        return name, 0
    i = int(parts[1])
    return f"groups.{i % len(cfg.layer_pattern)}.{parts[2]}", 1


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(ref, arch, tp):
    cfg = configs.get(arch)
    structs = steps.param_structs(cfg)
    got = pipeline.param_specs(cfg, structs, tp_axis="model", tp_size=tp)
    got_pipe = pipeline.param_specs(cfg, structs, tp_axis="tp", tp_size=tp)
    want = ref["params"][f"{arch}/{tp}"]
    assert len(got) == len(list(structs.parameters()))
    for name, spec in got.items():
        rname, stack = _ref_name(name, cfg)
        assert _plain(spec) == _plain(want["baseline"][rname][stack:]), name
        assert _plain(got_pipe[name]) == \
            _plain(want["pipeline"][rname][2 * stack:]), name
    # every reference leaf is some port parameter's
    assert {_ref_name(n, cfg)[0] for n in got} == set(want["baseline"])


def test_zero1_specs_match_reference(ref):
    for (spec, shape, data), want in zip(ZERO1_CASES, ref["zero1"]):
        got = zero1_specs({"x": spec}, {"x": shape},
                          data_axes=("pod", "data"), data_size=data)["x"]
        assert _plain(got) == _plain(want), (spec, shape, data)


@pytest.mark.parametrize("kv_shard", ["heads", "context"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(ref, arch, kv_shard):
    cfg = configs.get(arch)
    cache = lm.init_cache(steps.param_structs(cfg), cfg, CACHE_B, CACHE_SEQ,
                          device="meta")
    got = baseline.cache_shardings(cfg, cache, CACHE_MESH, kv_shard=kv_shard)
    want = ref["cache"][f"{arch}/{kv_shard}"]
    P = len(cfg.layer_pattern)
    n = 0
    for i, layer in enumerate(got["layers"]):
        stack = [(f"groups.{i % P}.{k}", v) for k, v in layer.items()
                 if not isinstance(v, dict)]
        stack += [(f"groups.{i % P}.{k}.{k2}", v2) for k, v in layer.items()
                  if isinstance(v, dict) for k2, v2 in v.items()]
        for rname, spec in stack:
            assert _plain(spec) == _plain(want[rname][1:]), (i, rname)
            n += 1
    assert n == sum(1 for k in want if k.startswith("groups.")
                    and not k.endswith(".pos")) * (cfg.n_layers // P)
    assert got["pos"] == () and want["pos"] == []


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_refined_layout_matches_reference(ref, case):
    """The same ranks where the reference's ``refined_mesh`` lays out its
    devices, and a ``ValueError`` where it raises one (uniform slabs that
    do not reshape to the data axis).  granite-8b's plan visits slot (1,
    0) twice: the reference's mesh then holds those devices twice, and
    the port's ``refined_mesh`` refuses the layout (a rank is one
    process)."""
    shape, how = PLAN_CASES[case]
    want = ref["refined"][case]
    if isinstance(how, str):
        plan = sharding.plan_cell(configs.get(how), "train_4k", shape,
                                  mode="tapa")
    else:
        plan = sharding.TpuPlan(mode="tapa", groups_per_stage=1,
                                crossing_cost=0.0, **how)
    ranks = np.asarray(want["mesh"])
    if "error" in want:
        with pytest.raises(ValueError):
            sharding.refined_layout(ranks, plan)
        return
    layout, axes = sharding.refined_layout(ranks, plan)
    assert list(axes) == want["axes"]
    assert layout.tolist() == want["ids"]
    if len(set(layout.reshape(-1).tolist())) < layout.size:
        assert case.startswith("granite-8b")
        with pytest.raises(ValueError, match="more than once"):
            sharding.check_layout(layout)
    else:
        assert sorted(layout.reshape(-1).tolist()) == list(range(
            ranks.size))


def test_refined_layout_of_the_baseline_plan():
    shape = (2, 4, 8)
    plan = sharding.plan_cell(configs.get("granite-8b"), "train_4k",
                              shape, mode="baseline")
    ranks = np.arange(64).reshape(shape)
    layout, axes = sharding.refined_layout(ranks, plan)
    assert axes == ("data", "model")
    assert layout.tolist() == ranks.reshape(8, 8).tolist()


def test_int8_compression_is_bit_equal(ref):
    rng = np.random.default_rng(7)
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * 10.0 ** i)
              for k, s in INT8_SHAPES.items()} for i in range(INT8_STEPS)]
    err = collectives.init_error_buf(grads[0])
    for step, (g, want) in enumerate(zip(grads, ref["int8"])):
        q, s, err = collectives.compress_grads(g, err)
        d = collectives.decompress_grads(q, s)
        for k in INT8_SHAPES:
            assert q[k].dtype == torch.int8
            np.testing.assert_array_equal(q[k].numpy(), want[k]["q"],
                                          err_msg=f"{step} {k}")
            assert float(s[k]) == want[k]["s"], (step, k)
            np.testing.assert_array_equal(
                err[k].numpy(), np.asarray(want[k]["e"], np.float32))
            np.testing.assert_array_equal(
                d[k].numpy(), np.asarray(want[k]["d"], np.float32))


def test_pipeline_params_round_trip():
    cfg = dataclasses.replace(configs.get_reduced("zamba2-7b"), n_layers=12)
    params = dict(lm.LM(cfg, "meta").named_parameters())
    stages = pipeline.to_pipeline_params(params, cfg, 2)
    assert [sum(n.startswith("layers.") for n in s) for s in stages] == \
        [sum(n.startswith("layers.") for n in params) // 2] * 2
    assert "shared.1.attn.wq" in stages[1] and "embed" in stages[1]
    back = pipeline.from_pipeline_params(stages, cfg)
    assert back.keys() == params.keys()
    assert all(back[n] is params[n] for n in params)
    assert list(pipeline.stage_layers(cfg, 2, 1)) == list(range(6, 12))
    with pytest.raises(ValueError):
        pipeline.stage_layers(cfg, 4, 0)


def test_production_mesh_needs_its_world_size():
    """``make_production_mesh`` touches nothing when imported and raises,
    naming the world size it needs, without a group of that size."""
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="256"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        mesh.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_n_micro_match_reference(arch):
    """The meta stand-ins have the reference's shapes for every cell and
    mode, and each model takes the reference's microbatch count."""
    from repro.distributed.taskgraph import SHAPES
    from repro.launch import steps as jsteps
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert steps.n_micro_for(cfg) == jsteps.n_micro_for(jcfg)
    for cell in SHAPES.values():
        for mode in ("baseline", "tapa"):
            got = steps.input_specs(cfg, cell, mode=mode)
            want = jsteps.input_specs(jcfg, cell, mode=mode)
            assert got["tokens"].device.type == "meta"
            assert tuple(got["tokens"].shape) == want["tokens"].shape
            assert got.keys() == want.keys()
            for k, v in got.get("extra", {}).items():
                assert tuple(v.shape) == want["extra"][k].shape, k
