"""The port's roofline tooling (``repro_torch.roofline``) against the JAX
package's, on the CPU.

- The reference's five roofline tests, on the same HLO snippets, through
  the port's copy of the HLO analyzer; the two analyzers' results equal.
- ``model_flops`` and ``active_param_count`` equal for every ``REGISTRY``
  config, for training and inference.
- ``roofline_from_trace`` on known work: a product's FLOPs counted on the
  local shards under a fake 16×16 mesh (in a fixture that destroys the
  process group), its bytes by the stated rule, and the collectives a
  redistribution issues, by the reference's kind names.
"""

import dataclasses

import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_analysis as jhlo
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.core.costmodel import H100
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import hlo_analysis as thlo
from repro_torch.roofline import RooflineTerms, roofline_from_trace

SIMPLE_HLO = """\
HloModule test

%body (p: (s32[], f32[128,256])) -> (s32[], f32[128,256]) {
  %p = (s32[], f32[128,256]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[128,256]{1,0} get-tuple-element(%p), index=1
  %w = f32[256,256]{1,0} constant({...})
  %dot.1 = f32[128,256]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[128,256]{1,0} all-reduce(%dot.1), replica_groups={}
  ROOT %t = (s32[], f32[128,256]{1,0}) tuple(%i, %ar)
}

%cond (p: (s32[], f32[128,256])) -> pred[] {
  %p = (s32[], f32[128,256]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %c = s32[] constant(8)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

ENTRY %main (a: f32[128,256]) -> f32[128,256] {
  %a = f32[128,256]{1,0} parameter(0)
  %init = (s32[], f32[128,256]{1,0}) tuple(%a)
  %wl = (s32[], f32[128,256]{1,0}) while(%init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"8"}}
  %ag = f32[256,256]{1,0} all-gather(%a), replica_groups={}
  ROOT %out = f32[128,256]{1,0} get-tuple-element(%wl), index=1
}
"""

VARIANTS = """
  %x.1 = bf16[16,512]{1,0} all-gather-start(%a), replica_groups={}
  %x.2 = bf16[16,512]{1,0} all-gather-done(%x.1)
  %y = f32[4]{0} collective-permute(%b), source_target_pairs={{0,1}}
"""

ARCHS = sorted(JAX_REGISTRY)


def test_loop_aware_flops_and_collectives():
    stats = thlo.analyze(SIMPLE_HLO)
    # dot: 2 * 128*256 * 256 flops, executed 8 times
    assert stats.flops == pytest.approx(8 * 2 * 128 * 256 * 256)
    # all-reduce inside the loop: 128*256*4 bytes × 8; all-gather outside
    ar = 8 * 128 * 256 * 4
    ag = 256 * 256 * 4
    assert stats.coll_breakdown["all-reduce"] == pytest.approx(ar)
    assert stats.coll_breakdown["all-gather"] == pytest.approx(ag)
    assert stats.collective_bytes == pytest.approx(ar + ag)
    assert dataclasses.asdict(stats) == \
        dataclasses.asdict(jhlo.analyze(SIMPLE_HLO))


def test_multipliers_nested():
    comps = thlo.parse_module(SIMPLE_HLO)
    mult = thlo._multipliers(comps)
    assert mult["body"] == 8
    assert mult["main"] == 1
    assert mult == jhlo._multipliers(jhlo.parse_module(SIMPLE_HLO))


def test_collective_bytes_regex_variants():
    coll = tanalysis.collective_bytes(VARIANTS)
    assert coll["all-gather"] == 16 * 512 * 2
    assert coll["collective-permute"] == 4 * 4
    assert coll == janalysis.collective_bytes(VARIANTS)
    assert tanalysis.COLLECTIVE_OPS == janalysis.COLLECTIVE_OPS


def test_model_flops_moe_uses_active_params():
    dense = TORCH_REGISTRY["phi3-mini-3.8b"]
    moe = TORCH_REGISTRY["mixtral-8x22b"]
    mf = tanalysis.model_flops
    assert mf(dense, 100) == pytest.approx(6 * dense.param_count() * 100)
    assert mf(moe, 100) < 6 * moe.param_count() * 100
    assert mf(moe, 100) == pytest.approx(6 * moe.active_param_count() * 100)


def test_param_counts_sane():
    """Analytic parameter counts near the advertised sizes."""
    expect = {
        "gemma2-9b": (8e9, 11e9),
        "phi3-mini-3.8b": (3.3e9, 4.3e9),
        "mamba2-370m": (0.3e9, 0.45e9),
        "codeqwen1.5-7b": (6e9, 8.5e9),
        "mixtral-8x22b": (130e9, 150e9),
        "qwen2-vl-72b": (65e9, 80e9),
        "minicpm3-4b": (3.3e9, 5e9),
        "zamba2-7b": (6e9, 9e9),
        "whisper-medium": (0.6e9, 1.0e9),
        "granite-moe-3b-a800m": (2.5e9, 4e9),
    }
    for name, (lo, hi) in expect.items():
        n = TORCH_REGISTRY[name].param_count()
        assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B"


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    jc, tc = JAX_REGISTRY[arch], TORCH_REGISTRY[arch]
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.param_count() == jc.param_count()
    for train in (True, False):
        assert tanalysis.model_flops(tc, 4096, train) == \
            janalysis.model_flops(jc, 4096, train)


def test_terms_row_has_the_reference_keys():
    terms = RooflineTerms(compute_s=1.0, memory_s=2.0, collective_s=0.5,
                          flops=3.0, hbm_bytes=4.0, coll_bytes=5,
                          model_flops=1.5)
    ref = janalysis.RooflineTerms(compute_s=1.0, memory_s=2.0,
                                  collective_s=0.5, flops=3.0, hbm_bytes=4.0,
                                  coll_bytes=5, model_flops=1.5)
    assert terms.row() == ref.row()
    assert terms.dominant == "memory"
    assert terms.useful_flops_ratio == 0.5


def test_trace_counts_a_plain_product():
    """(64, 128) @ (128, 32) fp32: 2·64·128·32 FLOPs; the product reads
    both operands and writes its output once (the transpose view moves
    nothing); no collective."""
    a = torch.randn(64, 128)
    w = torch.randn(32, 128)
    out, terms = roofline_from_trace(lambda x, y: x @ y.t(), a, w)
    assert torch.equal(out, a @ w.t())
    assert terms.flops == 2 * 64 * 128 * 32
    assert terms.hbm_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert terms.coll_bytes == 0
    assert terms.compute_s == terms.flops / H100.flops
    assert terms.memory_s == terms.hbm_bytes / H100.hbm_bw
    assert terms.dominant == "memory"


@pytest.fixture
def fake_mesh():
    from repro_torch.launch.mesh import close_mesh, make_production_mesh
    mesh = make_production_mesh()
    try:
        yield mesh
    finally:
        close_mesh()


def test_trace_counts_local_flops_and_collectives(fake_mesh):
    """Under the fake 16×16 mesh: x (1024, 3072) split by rows over
    "data", w (3072, 8192) split by rows over "data" and columns over
    "model". ``DTensor`` gathers x's columns (an all-gather) and runs a
    (1024, 192) @ (192, 512) product on each device; the reduce-scatter
    back to rows and columns is a second collective. The FLOPs are the
    local product's, a 256th of the global one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import REGISTRY
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(1024, 3072), fake_mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(3072, 8192), fake_mesh,
                              [Shard(0), Shard(1)])

        def fn(x, w):
            return (x @ w).redistribute(fake_mesh, [Shard(0), Shard(1)])
        out, terms = roofline_from_trace(
            fn, x, w, cfg=REGISTRY["phi3-mini-3.8b"], tokens=1024,
            n_devices=256, train=False, arg_bytes=123)
        assert tuple(out.to_local().shape) == (64, 512)
    assert terms.flops == 2 * 1024 * 192 * 512
    assert terms.flops * 256 == 2 * 1024 * 3072 * 8192
    assert terms.coll_breakdown["all-gather"] == 1024 * 3072 * 4
    assert terms.coll_breakdown["reduce-scatter"] == 64 * 512 * 4
    assert terms.coll_bytes == sum(terms.coll_breakdown.values())
    assert terms.collective_s == terms.coll_bytes / H100.link_bw
    assert set(terms.coll_breakdown) == set(tanalysis.COLLECTIVE_OPS)
    assert terms.per_device_peak_bytes == 123
    assert terms.model_flops == pytest.approx(
        2 * REGISTRY["phi3-mini-3.8b"].active_param_count() * 1024 / 256)
