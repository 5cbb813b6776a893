"""Every file of the benchmark loads, BENCHMARK.json names what the files
hold, and a cell, configuration, traffic mix or per-layer metric added as new
files is picked up with no other edit."""
import json

import pytest

from portbench.bench import layout
from portbench.tests.tiny import add_tiny, copy_bench, write

SPEC = layout.benchmark_spec()


@pytest.mark.parametrize("cell", layout.names("workloads"))
def test_every_workload_loads(cell):
    c = layout.load_cell(cell)
    assert c.workload["name"] == cell
    assert set(c.limits) == {"batch_mismatches", "loss_gap", "grad_gap", "update_gap",
                             *filter(None, [getattr(c.family, "KERNEL_NUMBER", None)])}
    assert c.limits["batch_mismatches"] == 0
    assert c.config["name"] == c.workload["config"]
    for fn in ("leaf_shapes", "loss", "model_flops"):
        assert callable(getattr(c.family, fn))
    assert callable(c.driver.run) and callable(c.source.make)


def test_benchmark_json_matches_the_files():
    assert [w["name"] for w in SPEC["workloads"]] == layout.names("workloads")
    for w in SPEC["workloads"]:
        f = layout.load_json("workloads", w["name"])
        assert {k: f[k] for k in ("name", "config", "traffic", "chips", "why")} == w
        layout.load_json("traffic", w["traffic"])
    for c in SPEC["configs"]:
        f = json.loads((layout.ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "train_tokens_per_s", "step_ms_p90", "setup_s"}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    mod = layout.load_module("metrics", metric)
    assert callable(mod.read)
    m = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    assert m["moves"] == "train_tokens_per_s"
    assert set(m.get("workloads", [])) <= {w["name"] for w in SPEC["workloads"]}


def test_kernel_families_load_and_attribute_names():
    from portbench.bench.trace import Families

    fam = Families(layout.kernel_families())
    names = {
        "void (anonymous namespace)::ssd_chunk_out<float>(float const*)": ("ssd_scan", "forward"),
        "void (anonymous namespace)::ssd_bwd_chunk<float>(float const*)": ("ssd_scan",
                                                                           "backward"),
        "void (anonymous namespace)::ssd_bwd_group_sum<float>(float const*)": ("ssd_scan",
                                                                               "backward"),
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": ("matmul", "gemm"),
        "nvjet_tst_192x192_64x3_2x1_v_bz_coopA_NNT": ("matmul", "gemm"),
        "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>": None,
    }
    for name, want in names.items():
        assert fam.of(name) == want, name


@pytest.mark.parametrize("name,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)",
     "vectorized_elementwise_kernel"),
    ("void at::native::(anonymous namespace)::reduce_kernel<512, 1>(float*)", "reduce_kernel"),
    ("void (anonymous namespace)::ssd_state_pass<float>(float const*)", "ssd_state_pass"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD "),
])
def test_breakdown_names_a_kernel_by_its_short_name(name, short):
    from portbench.bench.trace import short_name

    assert short_name(name) == short


def test_new_files_alone_add_a_cell_and_a_metric(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a workload and a per-layer metric
    dropped into a copy of the folder: the harness runs the new cell and
    reports the new metric, and no existing file changed."""
    import torch

    import portbench.run as run

    base = copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cell = add_tiny(base, "ssm")
    (base / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(run['window']['steps'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "train_tokens_per_s", "workloads": [cell]})
    write(tmp_path / "BENCHMARK.json", spec)
    assert cell in layout.names("workloads", base=base)
    out = run.execute(cell, 5, 0.2, True, torch.device("cpu"), base=base, root=tmp_path)
    assert out["metrics"]["steps_seen"]["value"] >= 1
    assert out["correct"], out["checks"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
