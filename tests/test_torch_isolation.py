"""The port stands alone: nothing under src/repro_torch (nor chip_smoke.py,
the port's tools or its examples) imports jax or the reference package,
and the port, its service tier, entry points and training half included,
imports with both blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("torch_*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py")))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'repro_torch.kernels.ops' in mods, mods\n"
        "assert {'repro_torch.service', 'repro_torch.service.service',\n"
        "        'repro_torch.service.__main__'} <= set(mods), mods\n"
        "assert {'repro_torch.launch.serve', 'repro_torch.configs.drim_ann',\n"
        "        'repro_torch.core.multiplierless',\n"
        "        'repro_torch.core.dpq'} <= set(mods), mods\n"
        "assert {'repro_torch.models', 'repro_torch.models.transformer',\n"
        "        'repro_torch.configs.registry',\n"
        "        'repro_torch.launch.specs'} <= set(mods), mods\n"
        "from repro_torch.service import AnnService, ServiceSpec\n"
        "from repro_torch.launch.serve import main, serve_ann\n"
        "from repro_torch.configs.drim_ann import config\n"
        "from repro_torch.core.multiplierless import scan_codes_int\n"
        "from repro_torch.core.dpq import train_dpq\n"
        "from repro_torch.models import init_params, decode_step\n"
        "from repro_torch.configs.registry import ARCH_IDS, get_config\n"
        "from repro_torch.launch.specs import count_params_analytic\n"
        "from repro_torch.launch.serve import generate, rag_context\n"
        "assert {'repro_torch.optim.adamw', 'repro_torch.optim.grad_compress',\n"
        "        'repro_torch.checkpoint.checkpointer',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.launch.steps',\n"
        "        'repro_torch.launch.train'} <= set(mods), mods\n"
        "from repro_torch.optim import AdamWConfig, update, ef_step\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        "from repro_torch.data import make_token_pipeline\n"
        "from repro_torch.launch.steps import make_train_step\n"
        "from repro_torch.launch.train import train_loop, main\n"
        "from repro_torch.launch.specs import input_specs\n"
        "from repro_torch.runtime import RunSupervisor, plan_elastic_mesh\n"
        "assert 'repro_torch.launch.mesh' in mods, mods\n"
        "from repro_torch.launch.mesh import Mesh, make_shard_mesh\n"
        "from repro_torch.core.sharded_search import (make_sharded_step,\n"
        "                                             make_sharded_step_lut)\n"
        "assert {'repro_torch.launch.dryrun', 'repro_torch.launch.roofline',\n"
        "        'repro_torch.launch.roofline_patch',\n"
        "        'repro_torch.launch.roofline_report',\n"
        "        'repro_torch.launch.perf_iterations',\n"
        "        'repro_torch.models.sharding'} <= set(mods), mods\n"
        "from repro_torch.launch.mesh import (make_production_mesh,\n"
        "    rules_for, resolve_pspec, shardings_for_tree, distribute_tree,\n"
        "    fake_world, BASE_RULES, NamedSharding, PartitionSpec)\n"
        "from repro_torch.launch.dryrun import run_cell, run_drim_ann_cell\n"
        "from repro_torch.launch.roofline import (analytic_roofline,\n"
        "    analyze_step, StepCounter, model_flops)\n"
        "from repro_torch.models import init_params_and_axes\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()   # importing touches no group\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
