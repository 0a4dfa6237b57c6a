"""The yardstick's arithmetic: the FLOP formulas against the dry run's
count of the program's step, the traced window's union of intervals, and
metrics that find nothing to read."""
from __future__ import annotations

import pytest
import torch

from portbench import costs, devtrace, harness
from portbench.tests import _tiny


def _model(cfg) -> dict:
    return {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab", "rope_theta", "n_experts", "top_k", "moe_d_ff")}


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m"])
def test_flops_agree_with_the_dry_runs_count(arch):
    """The program's training step (``lm.loss_fn`` and its backward) on
    meta tensors of a reduced config, counted by the dry run's
    ``FlopCounter``: its cuBLAS part is ``train_gemm_flops``, and the
    whole is the model FLOPs plus what the program does beyond them (the
    attention backward's recomputed scores, 2 D a pair, and the gathers'
    backward adds)."""
    from repro_torch import configs
    from repro_torch.kernels import shape_only
    from repro_torch.launch import dryrun
    from repro_torch.model import lm

    cfg = configs.get_reduced(arch)
    m = _model(cfg)
    B, S = 2, 24
    params = lm.LM(cfg, "meta")
    params.requires_grad_(True)
    tokens = torch.zeros((B, S + 1), dtype=torch.int32, device="meta")
    shape_only.reset()
    with dryrun.FlopCounter() as fc:
        lm.loss_fn(params, cfg, {"tokens": tokens}).backward()
    kernel = sum(shape_only.flops.values())
    T = B * (S + 1)
    assert fc.total - kernel == costs.train_gemm_flops(m, B, S + 1)
    pairs = costs.causal_pairs(B, S + 1, cfg.n_heads)
    beyond = cfg.n_layers * 2 * cfg.head_dim * pairs + T * cfg.d_model
    if cfg.n_experts:
        beyond += cfg.n_layers * T * cfg.top_k * cfg.d_model
    assert fc.total == costs.train_model_flops(m, B, S + 1) + beyond


def test_busy_is_the_union_of_intervals_and_gaps_name_the_host_op():
    ops = [devtrace.Op("k1", 100, 300), devtrace.Op("k2", 200, 400),
           devtrace.Op("Memcpy HtoD", 500, 600), devtrace.Op("k3", 900, 950)]
    host = [devtrace.Op(devtrace.WINDOW, 0, 1000),
            devtrace.Op("aten::item", 600, 880),
            devtrace.Op("cudaStreamSynchronize", 610, 870)]
    tr = devtrace.Trace(ops, host, 0, 1000, units=2)
    assert tr.busy() == [(100, 400), (500, 600), (900, 950)]
    assert tr.busy_s == pytest.approx(450e-9)
    assert [k.name for k in tr.kernels()] == ["k1", "k2", "k3"]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(300e-9)]
    assert sorted(g[1] for g in gaps) == pytest.approx(
        [50e-9, 100e-9, 100e-9, 300e-9])
    assert tr.device_ops()[0] == ["k1", pytest.approx(200e-9)]


def _reading(kind: str, names: list[str]):
    c = _tiny.moe()
    ops = [devtrace.Op(n, 10 * i, 10 * i + 5) for i, n in enumerate(names)]
    tr = devtrace.Trace(ops, [devtrace.Op(devtrace.WINDOW, 0, 1000)], 0,
                        1000, units=1)
    return harness.Reading(kind, c.model, c.traffic, 1.0, 1, trace=tr)


@pytest.mark.parametrize("metric", [
    "gemm_roofline.train", "attn_roofline.train", "moe_roofline.train",
    "elementwise_ms.train"])
def test_a_metric_whose_kernels_did_not_run_reads_nothing(metric):
    """Only other kernels in the trace (or none): no reading, never 0."""
    read = harness.metric_reader(metric)
    r = _reading("train", ["void some_other_kernel<4>()"])
    assert read(r) is None
    r.trace = None
    assert read(r) is None


def test_metrics_read_their_own_kernels():
    r = _reading("train", [
        "void (anonymous namespace)::flash_bwd_kv_wg<128, 1>(int)",
        "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT",
        "void (anonymous namespace)::gmm_dw_wgmma<256, 4>(int)",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::AUnaryFunctor<float>>(int)"])
    for metric in ("gemm_roofline.train", "attn_roofline.train",
                   "moe_roofline.train", "elementwise_ms.train",
                   "launches_per_step.train", "idle_pct.train"):
        assert harness.metric_reader(metric)(r) > 0, metric


def test_a_cpu_run_leaves_out_what_it_cannot_read():
    """A traced run with no device operations: the device metrics are
    absent from the line, the host-clock ones present."""
    out = _tiny.run(_tiny.cell("train4k.granite-8b"), trace=1)
    assert set(out["metrics"]) == {"mfu.train"}
    out = _tiny.run(_tiny.cell("serve-longprompt.granite-8b"), trace=1)
    assert set(out["metrics"]) == {"mfu.serve", "decode_step_ms.serve"}
    assert list(out)[-1] == "checks"
