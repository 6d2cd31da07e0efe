"""The port's roofline module (``repro_torch/roofline.py``) against the JAX
package's ``repro/roofline.py``, on the CPU.

  * Exact equality: ``analytic_flops`` and ``analytic_hbm_bytes`` for every
    registered config x ``SHAPES`` x ``n_micro`` in {1, 2}; the kernel byte
    models, ``probe_extrapolate`` and ``kernel_roofline``; and
    ``roofline_terms`` once both use the same constants (the port's
    defaults are the H100's).
  * ``StepTrace``: the per-device forward FLOPs of ``test_roofline.py``'s
    ``_tiny_cfg`` equal ``FlopCounterMode``'s count of the real
    (non-fake) forward exactly and lie within that test's 0.5-2 x band of
    XLA's (body-corrected) count; on a fake 4-rank mesh a sharded product
    counts a quarter of the global FLOPs, its collective's bytes, and the
    same numbers on a second call (DTensor's shape propagation, run on
    the first call only, is not counted).
"""
import dataclasses

import pytest
import torch

from repro import roofline as jroof
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import all_configs as jall_configs
from repro_torch import roofline as troof
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, all_configs


@pytest.mark.parametrize("name", sorted(all_configs()))
def test_analytic_models_equal_the_reference(name):
    cfg, jcfg = all_configs()[name], jall_configs()[name]
    for sname in SHAPES:
        for n_micro in (1, 2):
            assert (troof.analytic_flops(cfg, SHAPES[sname], n_micro)
                    == jroof.analytic_flops(jcfg, JSHAPES[sname], n_micro))
            assert (troof.analytic_hbm_bytes(cfg, SHAPES[sname], n_micro)
                    == jroof.analytic_hbm_bytes(jcfg, JSHAPES[sname], n_micro))


def test_kernel_byte_models_equal_the_reference():
    for n in (1, 341, 16384, 10_000_000):
        for d in (2, 5):
            for nq in (1, 1024):
                for bb in (2, 4):
                    assert (troof.bytes_box_hits_tiled(n, nq, d, bb)
                            == jroof.bytes_box_hits_tiled(n, nq, d, bb))
                    assert (troof.bytes_leaf_mindist_tiled(nq, n, d, bb)
                            == jroof.bytes_leaf_mindist_tiled(nq, n, d, bb))
            for s in (1, 341):
                assert troof.bytes_pair_window_ids(n, s, d) == jroof.bytes_pair_window_ids(n, s, d)
                assert troof.bytes_pair_dist2(n, s, d) == jroof.bytes_pair_dist2(n, s, d)
    # ROADMAP A.1: the reference's model of phase 3's pair scan
    assert troof.bytes_pair_window_ids(16384, 341, 2) == 89_784_320      # 89.8 MB


def test_probe_extrapolation_and_kernel_roofline_equal_the_reference():
    probe = {"blocks1": {"flops": 130.0, "bytes_accessed": 1300.0, "collective_bytes": 13.0},
             "blocks2": {"flops": 230.0, "bytes_accessed": 2300.0, "collective_bytes": 23.0}}
    for n in (1, 10, 94):
        assert troof.probe_extrapolate(probe, n) == jroof.probe_extrapolate(probe, n)
    for bytes_moved, seconds in ((1e9, 1e-3), (58.3e6, 1.74e-5)):
        assert (troof.kernel_roofline(bytes_moved, seconds, bw=jroof.HBM_BW)
                == jroof.kernel_roofline(bytes_moved, seconds))
        got = troof.kernel_roofline(bytes_moved, seconds)
        assert got["peak_gbps"] == 3350.0
    with pytest.raises(ValueError):
        troof.kernel_roofline(1.0, 0.0)


@pytest.mark.parametrize("args", [(1e15, 1e12, 1e11, 256), (1e12, 1e14, 1e11, 256),
                                  (1e12, 1e10, 1e14, 512), (0.0, 0.0, 0.0, 4)])
def test_roofline_terms_equal_the_reference_at_its_constants(args):
    want = jroof.roofline_terms(*args)
    got = troof.roofline_terms(*args, peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW,
                               link_bw=jroof.ICI_BW)
    assert got == want


def test_h100_constants():
    """NVIDIA H100 SXM5 80 GB data sheet (700 W), the numbers chip_smoke.py
    holds too."""
    assert troof.PEAK_FLOPS == 989e12 and troof.PEAK_FLOPS_F32 == 67e12
    assert troof.HBM_BW == 3.35e12 and troof.NVLINK_BW == 450e9
    t = troof.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


def _tiny_cfg(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=128, vocab=128, dtype="float32", chunk_q=32)
    base.update(kw)
    return ModelConfig(**base)


def _xla_prefill_flops(cfg_kw, shape_kw) -> float:
    """``test_roofline.py``'s body-corrected XLA count of the prefill."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JConfig
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.mesh import make_mesh, use_mesh
    from repro.models import model as JM
    from repro.models.sharding import MeshAxes

    base = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=128, vocab=128, dtype="float32", chunk_q=32)
    base.update(cfg_kw)
    cfg = JConfig(**base)
    shape = JShape(**shape_kw)
    mesh = make_mesh((1, 1), ("data", "model"))
    axes = MeshAxes()
    inputs = JM.input_specs(cfg, shape, mesh)

    def flops(c):
        params = JM.abstract_params(c, mesh, jnp.float32)
        with use_mesh(mesh):
            comp = jax.jit(lambda p, b: JM.prefill(p, c, b, axes)).lower(params, inputs).compile()
        return jroof.cost_analysis_dict(comp)["flops"]

    xla, xla1 = flops(cfg), flops(dataclasses.replace(cfg, n_layers=1))
    return xla1 + max(xla - xla1, 0.0) * cfg.n_layers


def test_forward_flops_per_device():
    """The traced prefill's FLOPs equal the real forward's FlopCounterMode
    count exactly, and lie within 0.5-2 x of XLA's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import LM

    cfg = _tiny_cfg()
    shape = dict(name="t", seq_len=32, global_batch=4, kind="prefill")
    tokens = torch.randint(0, cfg.vocab, (4, 32))
    lm = LM(cfg, device="cpu")
    with FlopCounterMode(display=False) as fc:
        lm.prefill(tokens)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = LM(cfg, device="cpu", empty=True)
        trace = troof.StepTrace()
        with trace:
            fake.prefill(torch.empty(4, 32, dtype=torch.int64))
    assert trace.flops == fc.get_total_flops() > 0
    xla = _xla_prefill_flops({}, shape)
    assert 0.5 < trace.flops / xla < 2.0, (trace.flops, xla)
    ana = troof.analytic_flops(cfg, ShapeConfig(**shape))["fwd_flops"]
    assert 0.5 < ana / trace.flops < 2.0


def test_step_trace_counts_local_work_on_a_fake_mesh():
    """A (64, 32) x (32, 16) product with the rows split over 'data' and the
    columns over 'model' of a fake (2, 2) mesh: a quarter of the global
    FLOPs per device, the same on a second call."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world, make_mesh

    fake_world(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(1)])
            counts = []
            for _ in range(2):
                with troof.StepTrace() as t:
                    x @ w
                counts.append((t.flops, t.collectives()["total_bytes"]))
            assert counts[0] == counts[1] == (2 * 64 * 32 * 16 // 4, 0.0)
            # a gather over 'model': its result's bytes, one all-gather
            with troof.StepTrace() as t:
                w.redistribute(mesh, [Replicate(), Replicate()])
            assert t.collectives() == {"by_kind": {"all-gather": 32 * 16 * 4.0},
                                       "counts": {"all-gather": 1},
                                       "total_bytes": 32 * 16 * 4.0}
            assert t.op_census()["all-gather"] == 1
    finally:
        dist.destroy_process_group()


def test_step_trace_memory_peak_and_arguments():
    """Arguments registered first are live from the start; a temporary
    counts while it lives."""
    with troof.StepTrace() as t:
        a = torch.zeros(1000)                     # 4000 bytes
    assert t.peak_bytes == 4000 and t.live == 4000
    t2 = troof.StepTrace()
    t2.add_arguments([a])
    with t2:
        b = a * 2                                 # a temporary of 4000 bytes
        del b
        c = a + 1
    assert t2.arg_bytes == 4000 and t2.peak_bytes == 8000 and t2.live == 8000
    del c
    assert t2.live == 4000
