"""The benchmark's data files, its traffic generator, its metric arithmetic,
its import check and its operation and byte counts, on the CPU."""

import json
import statistics
import subprocess
import sys

import numpy as np
import pytest

from perfbench.harness import counts, layers, spec, traffic
from perfbench.harness.stats import Served, quartile_spread, window_metrics

BM = spec.benchmark()
CELLS = [w["name"] for w in BM["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.entry["chips"] == 1
    assert cell.mode in ("continuous", "kv_offload")
    assert cell.rate > 0
    assert cell.layout["check"]
    for name, c in cell.layout["check"].items():
        assert name in ("max_logit_gap", "mean_logit_gap",
                        "pool_page_bytes_off")
        # an exact comparison has the limit 0
        assert c["limit"] > 0 or name == "pool_page_bytes_off"
    assert ("pool_page_bytes_off" in cell.layout["check"]) == cell.offload
    assert cell.mix["name"] == cell.entry["traffic"]
    # a prompt and its longest output fit one row
    assert cell.mix["prompt_tokens"]["max"] \
        + cell.mix["output_tokens"]["max"] <= cell.layout["max_seq"]


@pytest.mark.parametrize("name", [c["name"] for c in BM["configs"]])
def test_each_config_matches_the_ports_registry(name):
    entry = next(c for c in BM["configs"] if c["name"] == name)
    with open(spec.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["name"] == name
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    cfg = spec.port_config(config)
    assert cfg.n_layers == config["num_hidden_layers"]


def test_a_config_that_drifts_from_the_registry_is_refused():
    cell = spec.load_cell(CELLS[0])
    bad = dict(cell.config, hidden_size=cell.config["hidden_size"] // 2)
    with pytest.raises(ValueError, match="differs"):
        spec.port_config(bad)


@pytest.mark.parametrize("metric", BM["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(layers.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BM["end_to_end"]}


def test_every_cell_reports_setup_and_a_metric_of_each_kind():
    names = {m["name"] for m in BM["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for name in CELLS:
        cell = spec.load_cell(name)
        assert spec.metric_specs(cell, "per_layer")
        e2e = {m["name"] for m in spec.metric_specs(cell, "end_to_end")}
        # the TTFT median only where the cell runs below its knee
        assert e2e == {"output_tok_s", "itl_p95_ms", "peak_device_gib",
                       "setup_s"} | ({"ttft_p50_ms"} if not cell.offload
                                     else set())
        for m in spec.metric_specs(cell, "per_layer"):
            assert m["moves"] in e2e, (name, m["name"])


def _mix(name="code"):
    with open(spec.BENCH / "mixes" / f"{name}.json") as f:
        return json.load(f)


def test_code_mix_is_deterministic_by_seed():
    mix = _mix()
    a = traffic.schedule(mix, 1.0, 51, 3_000_000_017, 32064)
    b = traffic.schedule(mix, 1.0, 51, 3_000_000_017, 32064)
    c = traffic.schedule(mix, 1.0, 51, 5, 32064)
    assert [x.due_s for x in a] == [x.due_s for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [x.due_s for x in a] != [x.due_s for x in c]


def test_code_mix_gives_every_seed_the_same_window():
    mix = _mix()
    lead = mix["lead_in_s"]
    a = traffic.schedule(mix, 0.8, 51, 1, 32064)
    b = traffic.schedule(mix, 0.8, 51, 2, 32064)
    for lo, hi in ((0, lead), (lead, lead + 51)):
        pa = [x for x in a if lo <= x.due_s < hi]
        pb = [x for x in b if lo <= x.due_s < hi]
        assert sorted(len(x.prompt) for x in pa) == \
            sorted(len(x.prompt) for x in pb)
        assert sorted(x.max_new_tokens for x in pa) == \
            sorted(x.max_new_tokens for x in pb)
        # the gaps, the last one running to the segment's end
        gaps = [sorted(np.round(np.diff([x.due_s for x in p] + [hi]), 9))
                for p in (pa, pb)]
        assert gaps[0] == gaps[1]
    win = [x for x in a if x.due_s >= lead]
    assert len(win) == round(0.8 * 51) and win[0].due_s == lead
    assert win[-1].due_s < lead + 51


@pytest.mark.parametrize("name,prompt_median,prompt_min,prompt_max",
                         [("code", 1500, 113, 4032),
                          ("code-1k", 384, 64, 960)])
def test_code_mix_matches_its_medians_and_clips(name, prompt_median,
                                                prompt_min, prompt_max):
    mix = _mix(name)
    # the published medians (Splitwise's figures for the Azure code trace)
    assert mix["published"] == {"prompt_tokens_median": 1500,
                                "output_tokens_median": 13}
    arr = traffic.schedule(mix, 4.0, 200, 9, 32064)
    prompts = [len(x.prompt) for x in arr]
    outs = [x.max_new_tokens for x in arr]
    assert abs(statistics.median(prompts) - prompt_median) <= 2
    assert abs(statistics.median(outs) - 13) <= 1
    # code's shortest prompt is the lognormal's lowest quantile, unclipped
    assert min(prompts) == prompt_min and max(prompts) == prompt_max
    assert min(outs) == 2 and max(outs) == 64
    gaps = np.diff([x.due_s for x in arr])
    assert abs(np.mean(gaps) - 0.25) < 0.01      # 4 requests a second
    assert 16.5 < np.mean(outs) < 18             # about 17 tokens
    assert all(x.prompt.max() < 32064 and x.prompt.min() >= 0 for x in arr)
    assert len(arr) == 4 * mix["lead_in_s"] + 4 * 200


def _served(due, stamps, n=None):
    return Served(due=due, submitted=due, prompt_len=8,
                  max_new_tokens=n if n is not None else len(stamps),
                  stamps=list(stamps), tokens=[1] * len(stamps))


def test_window_rate_counts_every_token_stamped_inside():
    served = [_served(0.0, [0.5, 1.5, 2.5]),      # lead-in request
              _served(1.2, [1.7, 10.5])]          # last token after close
    m = window_metrics(served, 1.0, 10.0)
    assert m["tokens"] == 3                         # 1.5, 2.5, 1.7
    assert m["output_tok_s"] == pytest.approx(3 / 9.0)
    assert m["requests_due"] == 1                   # the lead-in's is not


def test_ttft_tail_takes_censored_requests_at_the_close():
    served = [_served(1.0 + i, [1.0 + i + 0.1]) for i in range(9)]
    served.append(_served(5.0, [], n=4))            # never started
    m = window_metrics(served, 0.0, 20.0)
    ttft = [0.1] * 9 + [15.0]
    assert m["requests_censored"] == 1
    assert m["ttft_p90_ms"] == pytest.approx(1e3 * np.percentile(ttft, 90))
    assert m["ttft_p50_ms"] == pytest.approx(1e3 * np.percentile(ttft, 50))
    assert m["requests_completed"] == 9


def test_itl_takes_every_gap_of_every_request_inside():
    served = [_served(0.0, [0.5, 1.5, 1.6, 1.8]),
              _served(1.0, [1.2, 2.2, 4.2])]
    m = window_metrics(served, 1.0, 10.0)
    gaps = [0.1, 0.2, 1.0, 2.0]                     # 0.5 -> 1.5 is not
    assert m["itl_gaps"] == 4
    assert m["itl_p95_ms"] == pytest.approx(1e3 * np.percentile(gaps, 95))


def test_quartile_spread_is_statistics_quantiles():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert quartile_spread(vals) == pytest.approx((q3 - q1) / q2)


def test_import_check_compares_top_level_names_whole():
    sys.path.insert(0, str(spec.BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(spec.BENCH))
    assert run.forbidden_modules(["repro_torch", "repro_torch.api",
                                  "reprox", "numpy"]) == []
    assert run.forbidden_modules(["repro", "repro.models.moe", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.models.moe"]


def test_run_exits_nonzero_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        cwd=str(spec.ROOT))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_counts_reproduce_the_kernel_table_shapes():
    # B=4, S=T=512, 32 heads x 96, causal: 50.3 MB
    f, b = counts.flash_counts(4, 512, 512, 32, 32, 96)
    assert b == pytest.approx(50.33e6, rel=1e-3)
    assert f == pytest.approx(4 * 4 * 32 * 96 * 512 * 513 / 2)
    # ring C=576 at pos 520 in every row: 25.66 MB
    _, b = counts.ring_counts([520] * 4, 576, 32, 32, 96)
    assert b == pytest.approx(25.66e6, rel=1e-3)
    # rows at (520, 37, 0, 575): 14.0 MB
    _, b = counts.ring_counts([520, 37, 0, 575], 576, 32, 32, 96)
    assert b == pytest.approx(14.0e6, rel=2e-3)


def test_model_flops_follow_the_parameter_count():
    from repro_torch.configs import REGISTRY
    for entry in BM["configs"]:
        with open(spec.ROOT / entry["file"]) as f:
            config = json.load(f)
        cfg = REGISTRY[config["port_registry"]]
        per_layer, head = counts.matmul_params(config)
        embed_and_norms = cfg.vocab_size * cfg.d_model + cfg.d_model \
            + cfg.n_layers * 2 * cfg.d_model
        if config["architecture"] == "moe":
            assert per_layer * cfg.n_layers + embed_and_norms \
                == cfg.active_param_count()
        else:
            assert per_layer * cfg.n_layers + head + embed_and_norms \
                == cfg.param_count()
        one = counts.decode_flops(config, 0)
        assert one == pytest.approx(
            2 * (per_layer * cfg.n_layers + head)
            + 4 * cfg.n_heads * cfg.head_dim * cfg.n_layers)
