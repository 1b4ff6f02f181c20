"""The JAX package stays out: the run's check compares whole top-level
module names, and no file of the benchmark imports JAX, the JAX package or
the scripts from before the port."""

import ast
from pathlib import Path

from portbench import run as bench_run

PORTBENCH = Path(bench_run.__file__).resolve().parent


def test_forbidden_modules_compares_whole_top_level_names():
    modules = {"flow2gan_tpu_torch": 1, "flow2gan_tpu_torch.api": 1, "flow2gan_tpuish": 1,
               "numpy": 1}
    assert bench_run.forbidden_modules(modules) == []
    assert bench_run.forbidden_modules({**modules, "flow2gan_tpu": 1}) == ["flow2gan_tpu"]
    assert bench_run.forbidden_modules({**modules, "flow2gan_tpu.models.config": 1}) == [
        "flow2gan_tpu.models.config"]
    assert bench_run.forbidden_modules({"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1}) == [
        "flax.linen", "jax", "jaxlib.xla_client"]


def test_no_benchmark_file_imports_jax_or_the_old_scripts():
    banned = {"jax", "jaxlib", "flax", "flow2gan_tpu", "chip_smoke", "bench", "bench_train",
              "bench_gan", "bench_streaming", "adjoint_ab"}
    for path in PORTBENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "flow2gan_tpu" not in text.replace("flow2gan_tpu_torch/training/optim.py", ""), path
