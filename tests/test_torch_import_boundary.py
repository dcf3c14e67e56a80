"""The torch package and ``chip_smoke.py`` import neither JAX nor the JAX
package: every module imports in a subprocess where both are blocked, and no
file names either one in an import statement."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "karpenter_provider_aws_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "karpenter_provider_aws_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_BLOCKER = """
import importlib.abc, sys
FORBIDDEN = {forbidden!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("blocked: " + name)
        return None
for m in list(sys.modules):
    if any(m == f or m.startswith(f + ".") for f in FORBIDDEN):
        del sys.modules[m]
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import importlib.util
for name in {modules!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
assert not loaded, loaded
print("ok", len({modules!r}))
"""


def test_every_module_imports_with_jax_blocked():
    modules = _modules()
    code = _BLOCKER.format(
        forbidden=FORBIDDEN, root=str(ROOT), modules=modules,
        smoke=str(ROOT / "chip_smoke.py"),
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == f"ok {len(modules)}"


def test_the_consolidation_pass_modules_are_covered():
    modules = _modules()
    for name in ("market", "market.offerings", "ops.encode_delta", "ops.device_state",
                 "state.cluster", "catalog.pricing"):
        assert f"karpenter_provider_aws_tpu_torch.{name}" in modules, name


def test_the_disruption_half_modules_are_covered():
    modules = _modules()
    for name in ("controllers.disruption", "controllers.interruption",
                 "controllers.termination", "controllers.garbagecollection",
                 "controllers.liveness", "controllers.tagging",
                 "controllers.nodeclass_termination", "ops.cluster_cases", "testenv"):
        assert f"karpenter_provider_aws_tpu_torch.{name}" in modules, name
