"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
analysis (``repro_torch.launch.collective_analysis``), on fake process
groups in this process, with no card:

  * ``collective_summary`` equals the reference's
    ``repro.launch.hlo_analysis.collective_summary`` on the same
    collectives, written as HLO lines for the reference and as records for
    the port;
  * the reduced configs trace on a fake (2, 2, 2) group, as the
    reference's ``tests/test_dryrun_small.py`` compiles them (there marked
    slow, here not): granite-8b, chatglm3-6b, zamba2-7b and rwkv6 through
    ``build_baseline_train``, gemma3-12b's decode, and a 2-stage pipeline
    whose sends are recorded;
  * a trace runs every kernel's shape-only op and no plain version, and
    reads no pointer;
  * a dense reduced step's FLOPs equal the count written out from its
    config;
  * the byte tracker gives the same peak on a real CPU run of a step as
    on a fake trace of it.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.launch import hlo_analysis  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.sharding import TpuPlan  # noqa: E402
from repro_torch.distributed.taskgraph import SHAPES, ShapeCell  # noqa: E402
from repro_torch.kernels import ref, shape_only  # noqa: E402
from repro_torch.launch import collective_analysis, dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.model import lm  # noqa: E402
from _torch_sim import port_obs_isolation  # noqa: E402

assert port_obs_isolation  # the autouse fixture, imported to apply here

#: (HLO line of the reference, the port's record of the same collective)
COLLECTIVES = {
    "all-reduce in pods": (
        "  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1},{2,3}}, "
        "to_apply=%add",
        {"op": "all-reduce", "bytes": 4096, "groups": [[0, 1], [2, 3]]}),
    "all-gather iota": (
        "  %ag = bf16[8,256]{1,0} all-gather(%y), replica_groups=[2,4]<=[8],"
        " dimensions={1}",
        {"op": "all-gather", "bytes": 4096,
         "groups": [[0, 1, 2, 3], [4, 5, 6, 7]]}),
    "permute across pods": (
        "  %cp = f32[64]{0} collective-permute(%z), "
        "source_target_pairs={{0,4},{1,5}}",
        {"op": "collective-permute", "bytes": 256,
         "pairs": [[0, 4], [1, 5]]}),
    "all-reduce iota transposed": (
        "  %ar2 = bf16[4,32]{1,0} all-reduce(%w), "
        "replica_groups=[4,2]<=[2,4]T(1,0), to_apply=%add",
        {"op": "all-reduce", "bytes": 256,
         "groups": [[0, 4], [1, 5], [2, 6], [3, 7]]}),
    "all-to-all": (
        "  %a2a = f32[16,8]{1,0} all-to-all(%v), replica_groups={{0,1,2,3}},"
        " dimensions={0}",
        {"op": "all-to-all", "bytes": 512, "groups": [[0, 1, 2, 3]]}),
    "reduce-scatter": (
        "  %rs = bf16[128]{0} reduce-scatter(%u), replica_groups={{0,1},"
        "{2,3}}, dimensions={0}, to_apply=%add",
        {"op": "reduce-scatter", "bytes": 256, "groups": [[0, 1], [2, 3]]}),
    "permute in a pod": (
        "  %cp2 = bf16[2,64]{1,0} collective-permute(%t), "
        "source_target_pairs={{0,1},{2,3}}",
        {"op": "collective-permute", "bytes": 256,
         "pairs": [[0, 1], [2, 3]]}),
}


@pytest.mark.parametrize("case", list(COLLECTIVES) + ["all together"])
def test_collective_summary_matches_reference(case):
    cases = COLLECTIVES.values() if case == "all together" else \
        [COLLECTIVES[case]]
    hlo = "\n".join(line for line, _ in cases)
    records = [rec for _, rec in cases]
    for pod_size in (4, 1 << 30):
        want = hlo_analysis.collective_summary(hlo, pod_size=pod_size)
        got = collective_analysis.collective_summary(records,
                                                     pod_size=pod_size)
        assert got == want, (pod_size, got, want)


MESH = ((2, 2, 2), ("pod", "data", "model"))
TRAIN_CELL = ShapeCell("train_tiny", 32, 8, "train")
DECODE_CELL = ShapeCell("decode_tiny", 64, 8, "decode")
TWO_STAGES = TpuPlan(mode="tapa", n_stages=2, groups_per_stage=1,
                     stage_slots=[(0, 0), (0, 1)], boundary_depth=[2], tp=1,
                     crossing_cost=0.0)
#: case -> (arch, builder, the kernels its trace must launch)
SMALL = {
    "granite-8b": ("granite-8b", "baseline",
                   {"flash_attention", "flash_attention_bwd", "burst_gather",
                    "burst_gather_bwd"}),
    "chatglm3-6b": ("chatglm3-6b", "baseline",
                    {"flash_attention", "flash_attention_bwd"}),
    "zamba2-7b": ("zamba2-7b", "baseline",
                  {"mamba2_scan", "mamba2_scan_bwd", "flash_attention",
                   "flash_attention_bwd"}),
    "rwkv6-1.6b": ("rwkv6-1.6b", "baseline",
                   {"rwkv6_scan", "rwkv6_scan_bwd"}),
    "gemma3-12b decode": ("gemma3-12b", "serve", {"decode_attention"}),
    "granite-8b 2 stages": ("granite-8b", "tapa",
                            {"flash_attention", "flash_attention_bwd"}),
    # MoE experts over tp 2 (by expert), X layers and whisper's encoder
    "granite-moe-3b": ("granite-moe-3b-a800m", "baseline",
                       {"moe_plan", "moe_gmm", "moe_gmm_bwd",
                        "burst_gather", "burst_gather_bwd"}),
    "arctic-480b": ("arctic-480b", "baseline",
                    {"moe_plan", "moe_gmm", "moe_gmm_bwd"}),
    "llama-vision": ("llama-3.2-vision-11b", "baseline",
                     {"flash_attention", "flash_attention_bwd"}),
    "whisper-tiny decode": ("whisper-tiny", "serve", {"decode_attention"}),
}


def _small_step(arch, builder):
    cfg = configs.get_reduced(arch)
    mesh = make_mesh(*MESH, device_type="cpu")
    if builder == "serve":
        return steps.build_baseline_serve(cfg, mesh, DECODE_CELL,
                                          device="meta"), DECODE_CELL
    if builder == "tapa":
        return steps.build_tapa_train(cfg, mesh, TRAIN_CELL, plan=TWO_STAGES,
                                      n_micro=2, device="meta"), TRAIN_CELL
    return steps.build_baseline_train(cfg, mesh, TRAIN_CELL, n_micro=2,
                                      device="meta"), TRAIN_CELL


@pytest.mark.parametrize("case", list(SMALL))
def test_reduced_cells_trace_on_a_fake_group(case):
    arch, builder, kernels = SMALL[case]
    with dryrun.fake_group(8, 0):
        step, cell = _small_step(arch, builder)
        got = dryrun.trace(step, dryrun.stand_ins(step, cell))
    assert got["flops"] > 0 and got["aten_flops"] > 0
    assert kernels <= set(got["kernels"]), got["kernels"]
    assert got["peak_bytes_per_device"] >= got["arg_bytes"] > 0
    assert got["peak_bytes_per_device"] == (
        got["arg_bytes"] + got["out_bytes"] + got["temp_bytes"]
        - got["alias_bytes"])
    coll = collective_analysis.collective_summary(got["records"], pod_size=4)
    assert coll["count"] > 0, case
    if builder == "tapa":
        # the pipeline's stage exchange: a send a tick, forward and back
        assert coll["ops"]["collective-permute"] > 0
        # rank 0 is stage 0: it sends forward to one rank of stage 1 only
        pairs = {tuple(map(tuple, r["pairs"])) for r in got["records"]
                 if r["op"] == "collective-permute"}
        assert len(pairs) == 1 and next(iter(pairs))[0][0] == 0, pairs


def test_trace_launches_shape_only_ops_and_no_plain_version(monkeypatch):
    """zamba2-reduced's step at tp 2 and gemma3-reduced's decode traced
    with every plain version and ``Tensor.data_ptr`` made to raise."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain version or a pointer was reached")

    for name in ("attention_ref", "attention_lse", "mamba2_scan_ref",
                 "rwkv6_scan_ref", "burst_gather_ref", "moe_gmm_ref"):
        monkeypatch.setattr(ref, name, boom)
    monkeypatch.setattr(torch.Tensor, "data_ptr", boom)
    calls = {}
    for arch, builder in (("zamba2-7b", "baseline"), ("gemma3-12b", "serve"),
                          ("rwkv6-1.6b", "baseline")):
        with dryrun.fake_group(8, 0):
            step, cell = _small_step(arch, builder)
            dryrun.trace(step, dryrun.stand_ins(step, cell))
        calls.update(shape_only.calls)
    assert {"flash_attention", "flash_attention_bwd", "mamba2_scan",
            "mamba2_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd", "burst_gather",
            "burst_gather_bwd", "decode_attention"} <= set(calls), calls


def test_dense_step_flops_equal_the_count():
    """granite-8b-reduced's baseline step on one rank, 2 microbatches of
    2 x 16 tokens.  Each product's forward is 2 M K N, its backward twice
    that; every layer group (one layer) is recomputed in the backward up
    to its last product, whose inputs are saved before it runs, so the
    recomputation stops short of w_down (the checkpoint's early stop); the
    head runs in 8 chunks, each recomputed whole.  Kernels: the attention
    forward 4 D a (query, key) pair, twice (the recomputation), its
    backward 10 D, and the gather's backward an add an element."""
    cfg = configs.get_reduced("granite-8b")
    nm, mb, S = 2, 2, 16
    cell = ShapeCell("t", S, nm * mb, "train")
    with dryrun.fake_group(1, 0):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        step = steps.build_baseline_train(cfg, mesh, cell, n_micro=nm,
                                          device="meta")
        got = dryrun.trace(step, dryrun.stand_ins(step, cell))
    d, hd, ff, V, L = (cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab_padded,
                       cfg.n_layers)
    T = mb * S
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    layer = 2 * T * (d * q + 2 * d * kv + q * d + 2 * d * ff + ff * d)
    down = 2 * T * ff * d
    head = 2 * T * d * V
    fwd = L * layer + head
    aten = nm * (3 * fwd + L * (layer - down) + head)
    pairs = mb * cfg.n_heads * S * (S + 1) // 2
    kernel = nm * (L * (2 * 4 + 10) * hd * pairs + T * d)
    assert got["aten_flops"] == aten
    assert got["kernel_flops"] == kernel
    assert got["flops"] == aten + kernel


def test_byte_tracker_peak_equals_a_real_cpu_run():
    """granite-8b-reduced's baseline step on one rank on real CPU tensors
    and on fake ones (``FakeTensorMode``, the same ops: a CPU tensor runs
    the plain versions either way): the same arguments, peak and
    results."""
    cfg = configs.get_reduced("granite-8b")
    cell = ShapeCell("t", 16, 4, "train")
    out = {}
    for fake in (False, True):
        with dryrun.fake_group(1, 0):
            mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
            step = steps.build_baseline_train(cfg, mesh, cell, n_micro=2,
                                              device="cpu")
            mode = FakeTensorMode() if fake else None
            if mode is not None:
                mode.__enter__()
            try:
                params = step.shard(lm.LM(cfg, "cpu"))
                args = (params, step.init_opt(params), {
                    "tokens": torch.zeros((4, 17), dtype=torch.int32)})
                got = dryrun.trace(step, args, device_type="cpu")
            finally:
                if mode is not None:
                    mode.__exit__(None, None, None)
        out[fake] = {k: got[k] for k in ("arg_bytes", "peak_bytes_per_device",
                                         "out_bytes", "alias_bytes",
                                         "flops")}
    assert out[True] == out[False]
    assert out[False]["peak_bytes_per_device"] > out[False]["arg_bytes"]


def test_production_cell_stand_ins_are_one_ranks_shards():
    """rwkv6-1.6b's decode_32k on the production mesh's rank 0: the cache
    and the parameters are one rank's (a 16th of the heads, 8 of the 128
    rows), on the meta device."""
    cfg = configs.get("rwkv6-1.6b")
    cell = SHAPES["decode_32k"]
    with dryrun.fake_group(256, 0):
        mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
        step = steps.build_baseline_serve(cfg, mesh, cell, device="meta")
        params, cache, tokens = dryrun.stand_ins(step, cell)
    wkv = cache["layers"][0]["wkv"]
    assert wkv.device.type == "meta"
    assert tuple(wkv.shape) == (128 // 16, cfg.d_model // cfg.ssm_head_dim
                                // 16, cfg.ssm_head_dim, cfg.ssm_head_dim)
    assert cache["pos"] == cell.seq_len - 1
    assert params.layers[0].rwkv.time_mix.wr.shape[1] == cfg.d_model // 16
    assert tuple(tokens.shape) == (cell.global_batch, 1)


def test_cells_for_matches_reference():
    from repro.launch import dryrun as jdryrun
    for arch in configs.ARCHS:
        assert dryrun.cells_for(arch) == jdryrun.cells_for(arch)
    assert dataclasses.asdict(SHAPES["long_500k"])["global_batch"] == 1
    assert np.prod(dryrun.MESHES["multipod"]) == 512
