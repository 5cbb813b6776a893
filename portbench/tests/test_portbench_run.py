"""The command line: no card means no result and a non-zero exit, never a
CPU run; a folder with only the benchmark's files cannot run; a run's
imports load nothing of JAX or the JAX package, and the reference nothing
of the program."""
import json
import os
import subprocess
import sys
import textwrap

from portbench.bench import layout
from portbench.tests.tiny import add_tiny, copy_bench

ROOT = layout.ROOT


def _run(args, cwd, env=None):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(env or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result(tmp_path):
    out = _run(["portbench/run.py", "--workload", "mamba2-2.7b.train.s2048", "--seed",
                "2147483659", "--seconds", "1", "--trace", "0"], ROOT,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_cannot_run(tmp_path):
    copy_bench(tmp_path)  # BENCHMARK.json and portbench/, without src/
    out = _run(["portbench/run.py", "--workload", "mamba2-2.7b.train.s2048", "--seed", "1",
                "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_loads_nothing_of_jax_or_repro(tmp_path):
    """The harness's whole path on the CPU, in a fresh process, then its
    modules by top-level name compared whole."""
    base = copy_bench(tmp_path)
    cell = add_tiny(base, "ssm")
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(tmp_path)!r}]
        import torch
        import portbench.run as run
        out = run.execute({cell!r}, 3, 0.2, True, torch.device("cpu"),
                          base=run.Path({str(base)!r}), root=run.Path({str(tmp_path)!r}))
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"correct": out["correct"], "tops": tops}}))
    """)
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "repro_torch" in res["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(res["tops"])


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}]
        from portbench.bench import compare, flops, layout, reference, trace
        for name in layout.names("families", ".py"):
            layout.load_module("families", name)
        for name in layout.names("sources", ".py"):
            layout.load_module("sources", name)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & tops


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import portbench.run as run

    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]
