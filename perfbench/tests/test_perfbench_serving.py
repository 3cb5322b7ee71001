"""The harness's whole run on the CPU at the port's ``.reduced()`` widths
(the chip's check apart), the port against the plain references, the
float8 control and the faults the output check must catch."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import check, runner, serve, weights
from perfbench.reference import dense, moe
from perfbench.tests.cpu_cell import config_of, small_cell, widened

CPU = torch.device("cpu")
CELLS = ["phi3-offload-code", "granite-resident-code"]
SEED = 3_000_000_021


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, seconds=2.0, trace=False, seed=SEED, session_options=None):
    import time
    return runner.execute(cell, seed, seconds, trace, CPU,
                          time.perf_counter(), lead_in_s=0.5,
                          session_options=session_options)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "granite-moe-3b-a800m"])
def test_port_matches_reference_at_reduced_widths(name):
    """Prefill then greedy decode through the port's cache, in float32,
    against the reference's whole-sequence logits at every position."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models.model import build_model
    cfg = REGISTRY[name].reduced()
    base = {"architecture": "moe" if cfg.moe else "dense"}
    config = config_of(cfg, base)
    model = build_model(cfg)
    params = weights.make_params(model, 7, torch.float32, CPU)
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, 12)
        .astype(np.int32))[None]
    cache = model.init_cache(1, 32, torch.float32, CPU)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": prompt}, cache)
        outs, toks = [logits[0, 0]], []
        for pos in range(12, 20):
            tok = outs[-1].argmax().to(torch.int32)
            toks.append(int(tok))
            logits, cache = model.decode_step(params, cache,
                                              tok.reshape(1, 1), pos)
            outs.append(logits[0, 0])
    seq = torch.cat([prompt[0], torch.tensor(toks, dtype=torch.int32)])
    ref = (moe if cfg.moe else dense).logits(config, params,
                                             [(seq, 12, 11)])[0]
    got = torch.stack(outs)
    assert got.shape == ref.shape
    assert torch.allclose(got, ref, atol=2e-4, rtol=1e-4), \
        (got - ref).abs().max()


def test_reference_drops_expert_assignments_as_the_port_does():
    """A prompt long enough that experts overflow their capacity: the
    port's routed layer and the reference's agree, drops included."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import _moe_ffn_local, route
    cfg = REGISTRY["granite-moe-3b-a800m"].reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=4, top_k=2, capacity_factor=1.0))
    config = config_of(cfg, {"architecture": "moe"})
    params = weights.make_params(build_model(cfg), 3, torch.float32, CPU)
    layer = dense._layer(params["segments"][0]["p0"], 0)
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    r = route(cfg, layer["ffn"]["router"], x[0])
    assert not bool(r.keep.all())                      # something dropped
    with torch.no_grad():
        port, _ = _moe_ffn_local(cfg, layer["ffn"], x)
        ref = moe.routed_ffn(config, layer, x[0], 64, dense.fp32_matmul)
    assert torch.allclose(port[0], ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_of_each_cell_is_correct(name, monkeypatch):
    cell = small_cell(name, monkeypatch)
    result, notes = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 10 and result["failed"] == 0
    # no peak on the CPU
    assert set(result["metrics"]) == {"output_tok_s", "itl_p95_ms",
                                      "setup_s"} | (
        set() if cell.offload else {"ttft_p50_ms"})
    assert notes["sample_tokens"] >= check.SAMPLE_TOKENS
    if cell.offload:        # every page moved at its bfloat16 size
        assert result["checks"]["pool_page_bytes_off"]["value"] == 0
        assert notes["sched"]["pages_parked"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,metrics", [
    ("phi3-offload-code", ("sched.decode_ms_per_step",
                           "pool.park_fetch_ms_per_step", "model.mfu_pct")),
    ("granite-resident-code", ("sched.prefill_ms_per_step",
                               "sched.decode_ms_per_step", "model.mfu_pct",
                               "model.mfu_pct.prefill_steps"))])
def test_a_traced_cpu_run_reads_the_span_and_counter_metrics(
        name, metrics, monkeypatch):
    result, _ = _run(small_cell(name, monkeypatch), trace=True)
    m = result["metrics"]
    for metric in metrics:
        assert m[metric]["value"] > 0, metric
    assert ("pool.spill_bytes_per_token" in m) == (name == "phi3-offload-code")
    # no device trace on the CPU: those readers find nothing
    assert "device.idle_pct" not in m
    assert "flash_attention_roofline" not in m


@pytest.mark.parametrize("name,size", [
    ("phi3-offload-code", ("phi3-mini-3.8b", 1536, 4096, 2)),
    ("granite-resident-code", None)])
def test_float8_control_separates_from_the_program(name, size, monkeypatch):
    """The control, the reference with float8 products in the program's
    place, goes through the benchmark's own check against the cell's own
    limits on the samples of three seeds, and comes out as not correct,
    while the program's run is correct. phi3 at a wider size than
    ``.reduced()``: its limit is on the widest gap, which grows with the
    logits' scale (about the square root of the width); granite's mean gap
    separates at ``.reduced()`` widths."""
    import time
    cfg = widened(*size) if size else None
    cell = small_cell(name, monkeypatch, cfg=cfg)
    for seed in (11, 12, 13):
        win, session = serve.run(cell, seed, 2.0, False, CPU,
                                 time.perf_counter(), lead_in_s=0.5)
        session.close()
        ok, numbers, _ = runner.verdict(cell, win, seed, CPU)
        assert ok, numbers
        ok, numbers, _ = runner.verdict(cell, win, seed, CPU, control=True)
        assert ok is False, numbers


def test_the_programs_float8_page_codec_is_not_correct(monkeypatch):
    """The program's own lower-precision path, float8 KV pages below the
    device tier: the run's widest gap stays near the program's, but the
    pool's pages no longer move at their bfloat16 size."""
    from repro_torch.api.config import KVCodecConfig
    cell = small_cell("phi3-offload-code", monkeypatch, device_tier_rows=1)
    result, notes = _run(cell, session_options={
        "kv_codec": KVCodecConfig(codec="fp8", below_tier="host")})
    assert notes["sched"]["cold_spills"] > 0
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["pool_page_bytes_off"]["value"] > 0
    assert result["checks"]["max_logit_gap"]["value"] \
        <= result["checks"]["max_logit_gap"]["limit"]


def _altered_tokens(monkeypatch):
    """A served token altered where it is produced: every greedy pick
    after the first few moves to the next vocabulary id."""
    from repro_torch.sched import scheduler
    real, calls = scheduler.sample_token, [0]

    def altered(logits, *a, **kw):
        out = real(logits, *a, **kw)
        calls[0] += 1
        return (out + 1) % logits.shape[-1] if calls[0] > 5 else out

    monkeypatch.setattr(scheduler, "sample_token", altered)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the new token's
    keys and values never reach the cache."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write_token",
                        lambda buf, vals, pos: None)


def _half_batch(monkeypatch):
    """Half of the batch left out: the odd rows of every decode step get
    the even rows' logits."""
    from repro_torch.sched import scheduler
    real = scheduler.jit_decode

    def halved(model):
        fn = real(model)

        def step(*a):
            logits, cache = fn(*a)
            logits = logits.clone()
            logits[1::2] = logits[0::2]
            return logits, cache

        return step

    monkeypatch.setattr(scheduler, "jit_decode", halved)


@pytest.mark.parametrize("fault", [_altered_tokens, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch"])
@pytest.mark.parametrize("name", ["phi3-offload-code",
                                  "granite-resident-code"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name, monkeypatch)
    fault(monkeypatch)
    result, _ = _run(cell)
    assert result["correct"] is False, result["checks"]
