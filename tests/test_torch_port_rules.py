"""Rules of the PyTorch port, checked statically and against the JAX package.

* ``src/repro_torch/**`` and ``chip_smoke.py`` import no ``jax`` and no
  module of ``repro`` (absolute, or relative imports that climb out of
  ``repro_torch``): the port keeps its own copies.
* ``examples/*_torch.py`` import the data service of ``repro``
  (``repro.core``, ``repro.data``) and nothing else of it, no ``jax``, and
  importing one loads no ``jax`` module.
* The port's config registry equals the JAX one field by field.
* The kernel layer imports nothing of the launch layer, and its wrappers
  leave the device decision to the one route rule (``kernels/_route.py``).
"""
import ast
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as jax_configs
from repro.models import config as jax_model_config
from repro_torch import configs as torch_configs
from repro_torch.models import config as torch_model_config

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
SERVICE = ("repro.core", "repro.data")


def _imported_modules(path: Path):
    """Absolute names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    if not path.is_relative_to(ROOT / "src"):  # chip_smoke.py, examples: no package
        package = []
    else:
        package = list(path.relative_to(ROOT / "src").parent.parts)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - (node.level - 1)] if node.level - 1 else package
                if node.level - 1 > len(package):
                    yield "<relative import above src>"
                    continue
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or name.startswith("<")


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in ("chip_smoke.py", "src/repro_torch/models/lm.py",
                 "src/repro_torch/models/encdec.py",
                 "src/repro_torch/kernels/flash_attention/ops.py",
                 "src/repro_torch/serve/engine.py", "src/repro_torch/bridge.py",
                 "src/repro_torch/feed/feeder.py", "src/repro_torch/train/step.py",
                 "src/repro_torch/obs/registry.py",
                 "src/repro_torch/kernels/fused_augment/ops.py",
                 "src/repro_torch/kernels/_shape.py"):
        assert want in names
    launch = {p.name for p in (PORT / "launch").glob("*.py")}
    assert {"__init__.py", "specs.py", "flops.py", "roofline.py", "dryrun.py", "report.py",
            "train.py"} <= launch
    assert {f"src/repro_torch/launch/{n}" for n in launch} <= names
    assert "mesh.py" in launch
    dist = {p.name for p in (PORT / "dist").glob("*.py")}
    assert {"__init__.py", "context.py", "sharding_rules.py", "compression.py",
            "placement.py"} <= dist
    assert {f"src/repro_torch/dist/{n}" for n in dist} <= names
    examples = {p.relative_to(ROOT).as_posix() for p in EXAMPLES}
    assert {"examples/train_e2e_torch.py", "examples/device_feed_torch.py"} <= examples


def test_kernels_import_no_launch_and_route_in_one_place():
    kernels = sorted((PORT / "kernels").rglob("*.py"))
    assert len(kernels) > 20
    bad = {p.relative_to(PORT).as_posix(): m for p in kernels for m in _imported_modules(p)
           if m.startswith("repro_torch.launch")}
    assert not bad, bad
    for ops in (PORT / "kernels").glob("*/ops.py"):
        text = ops.read_text()
        assert '("cuda", "meta")' not in text and ".launches += 1" not in text, ops


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _service_only(name: str) -> bool:
    top = name.split(".")[0]
    if top in ("jax", "jaxlib") or name.startswith("<"):
        return False
    return top != "repro" or any(name == m or name.startswith(m + ".") for m in SERVICE)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_examples_import_only_the_service(path):
    bad = [m for m in _imported_modules(path) if not _service_only(m)]
    assert not bad, f"{path} imports {bad}"
    assert any(m.startswith("repro.") for m in _imported_modules(path))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_importing_an_example_loads_no_jax(path):
    """Imported in a fresh interpreter (its ``main`` does not run), the file
    and everything it pulls in leave no ``jax`` module in ``sys.modules``."""
    import subprocess
    import sys

    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')))\n"
            "print('repro.core' in sys.modules and 'repro.data' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "", "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


def test_relative_import_resolution():
    """The scan resolves relative imports: ``from .. import x`` inside
    repro_torch/models stays in repro_torch."""
    mods = set(_imported_modules(PORT / "models" / "lm.py"))
    assert "repro_torch" in mods and "repro_torch.models.config" in mods


# The port's own config fields (the JAX config has none) and the values that
# are the JAX block: every preset leaves them there.
PORT_FIELDS = {"norm_type": "rms", "norm_eps": 1e-6, "use_bias": False}


def _as_jax(cfg):
    """The port's config as a dict of the JAX config's fields, after
    checking that its own fields hold the JAX block."""
    d = dataclasses.asdict(cfg)
    assert {k: d.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
    return d


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    want = jax_configs.get_config(arch)
    got = torch_configs.get_config(arch)
    assert _as_jax(got) == dataclasses.asdict(want)
    assert _as_jax(got.scaled_down()) == dataclasses.asdict(want.scaled_down())
    assert got.param_counts() == want.param_counts()


def test_registry_equal():
    assert torch_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert torch_configs._ALIASES == jax_configs._ALIASES
    for alias in jax_configs._ALIASES:
        assert _as_jax(torch_configs.get_config(alias)) == dataclasses.asdict(
            jax_configs.get_config(alias))
    assert {k: dataclasses.asdict(v) for k, v in torch_model_config.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_model_config.SHAPES.items()}
    with pytest.raises(KeyError):
        torch_configs.get_config("no-such-arch")
