"""The port stands alone: ``rten_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package, the entry points refuse to run
without a card unless the caller asks for the CPU, and the smoke test
fails (printing no result) where there is no card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rten_tpu)(\.|\s|$)", re.M)


def _no_card_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_pulls_in_no_jax():
    """Import every module of the package in a fresh interpreter; no jax*
    and no rten_tpu module may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rten_tpu_torch\n"
        "for m in pkgutil.walk_packages(rten_tpu_torch.__path__, 'rten_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rten_tpu_torch.kernels.flash_attention import (\n"
        "    decode_mha_append_cat_paged, paged_attention, paged_decode_mha, paged_targets)\n"
        "from rten_tpu_torch.ops.attention import paged_kv_update, paged_scale_update\n"
        "from rten_tpu_torch.kernels.flash_attention import mha, mha_plain\n"
        "from rten_tpu_torch.kernels.int4_matmul import dequant_nbits, int4_matmul\n"
        "from rten_tpu_torch.generate import Generator, MultinomialSampler, TopP\n"
        "from rten_tpu_torch.models.gpt2 import build_graph, load\n"
        "from rten_tpu_torch.quantize_pass import quantize_weight_only_int4\n"
        "from rten_tpu_torch.serialize import read_safetensors, write_safetensors\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rten_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('rten_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_no_card_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_sources_import_nothing_of_jax():
    files = sorted((ROOT / "rten_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f"{f} imports jax or rten_tpu"


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from rten_tpu_torch.ir.builder import GraphBuilder
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.runtime import Executor

    b = GraphBuilder()
    x = b.input("x")
    b.output(x + 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(b.finish())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(b.finish())
    m = Model(b.finish(), device="cpu")
    assert m.device.type == "cpu"
    assert m.run({"x": torch.ones(2)})[0].tolist() == [2.0, 2.0]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """No card: exit nonzero and print no result line. Alone (a directory
    holding only the script): the same."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = _no_card_env()
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
