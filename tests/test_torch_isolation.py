"""The port stands alone: ``rten_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package (nor ``regex``; the host libraries run
without ``regex``, PIL and ``tokenizers``), the entry points refuse to run
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
        "from rten_tpu_torch.serialize import read_safetensors, read_tensors, write_tensors\n"
        "from rten_tpu_torch.model import LoadError, Model\n"
        "from rten_tpu_torch.cli import main, quantize_model\n"
        "from rten_tpu_torch.formats.rten import load_rten, save_rten\n"
        "from rten_tpu_torch.formats.rtpu import load_model_graph, save_model\n"
        "from rten_tpu_torch.shape_inference import infer_shapes, infer_shapes_and_values\n"
        "from rten_tpu_torch.optimize import FUSIONS, optimize_graph\n"
        "from rten_tpu_torch.runtime.profiler import Profiler\n"
        "from rten_tpu_torch.ops.contrib import _skip_simplified_layer_norm\n"
        "from rten_tpu_torch.ops.gather import scatter\n"
        "from rten_tpu_torch.ops.random import RANDOM_OPS, seeded_generator\n"
        "from rten_tpu_torch.ops.moe import _moe\n"
        "from rten_tpu_torch.ops.attention import sdpa_with_sink\n"
        "from rten_tpu_torch.models.moe import MoEConfig, build_graph, random_weights\n"
        "from rten_tpu_torch.runtime.executor import RngSupply\n"
        "from rten_tpu_torch.text import Tokenizer\n"
        "from rten_tpu_torch.generate import TextDecoder\n"
        "from rten_tpu_torch.native import NativeBpe, get_lib\n"
        "from rten_tpu_torch.ctc import ctc_greedy_decode\n"
        "from rten_tpu_torch.imageproc import find_contours, nms_boxes\n"
        "from rten_tpu_torch.imageio import image_to_tensor\n"
        "from rten_tpu_torch.functional import arg_max\n"
        "from rten_tpu_torch.parallel import PipelineRunner, make_mesh, shard_model\n"
        "from rten_tpu_torch.parallel.partition import partition_graph\n"
        "from rten_tpu_torch.parallel.ring import ring_attention\n"
        "from rten_tpu_torch.ops.collective import sharded_argmax\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rten_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('rten_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_no_card_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_parallel_modules_import_alone():
    """The multi-device modules (``parallel/``, the collectives) each
    import in a fresh interpreter with neither ``jax`` nor ``rten_tpu``
    loaded, and the multi-process tests' rank helper imports neither."""
    mods = ["rten_tpu_torch.parallel", "rten_tpu_torch.parallel.distributed",
            "rten_tpu_torch.parallel.mesh", "rten_tpu_torch.parallel.sharding",
            "rten_tpu_torch.parallel.partition", "rten_tpu_torch.parallel.pipeline",
            "rten_tpu_torch.parallel.ring", "rten_tpu_torch.ops.collective"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rten_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_no_card_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    for f in sorted((ROOT / "rten_tpu_torch" / "parallel").glob("*.py")) + [
            ROOT / "rten_tpu_torch" / "ops" / "collective.py",
            ROOT / "tests" / "torch_parallel_worker.py"]:
        assert not FORBIDDEN.search(f.read_text()), f"{f} imports jax or rten_tpu"


def test_host_libraries_run_without_regex_pil_or_tokenizers():
    """The card machine is not promised ``regex``, PIL or ``tokenizers``:
    with the three blocked from import, the package imports whole, and the
    tokenizer (native and Python cores), the text decoder, imageproc, CTC
    and the functional helpers run on the CPU."""
    code = (
        "import sys\n"
        "for name in ('regex', 'PIL', 'tokenizers'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, numpy as np\n"
        "import rten_tpu_torch\n"
        "for m in pkgutil.walk_packages(rten_tpu_torch.__path__, 'rten_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rten_tpu_torch.text import Tokenizer\n"
        "from rten_tpu_torch.text.tokenizer import bytes_to_unicode\n"
        "from rten_tpu_torch.generate import TextDecoder\n"
        "from rten_tpu_torch import ctc, functional, imageproc\n"
        "vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}\n"
        "vocab['Ġh'] = 256\n"
        "spec = {'model': {'type': 'BPE', 'vocab': vocab, 'merges': ['Ġ h']},\n"
        "        'pre_tokenizer': {'type': 'ByteLevel', 'add_prefix_space': False},\n"
        "        'decoder': {'type': 'ByteLevel'}}\n"
        "text = 'ok hi, café 12'\n"
        "ids = [Tokenizer(spec, native=n).encode(text).ids for n in (True, False)]\n"
        "assert ids[0] == ids[1] and 256 in ids[0], ids\n"
        "assert ''.join(TextDecoder(Tokenizer(spec)).wrap(ids[0])) == text\n"
        "mask = np.zeros((6, 6), np.uint8); mask[1:4, 1:4] = 1\n"
        "assert len(imageproc.find_contours(mask)) == 1\n"
        "logp = functional.log_softmax(np.eye(4, dtype=np.float32) * 5, device='cpu')\n"
        "assert ctc.ctc_greedy_decode(logp).labels == [1, 2, 3]\n"
        "assert all(sys.modules[n] is None for n in ('regex', 'PIL', 'tokenizers'))\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_no_card_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_sources_import_no_regex():
    """The port writes tokenizer patterns for the standard ``re``
    (``text/pattern.py``): no source of the package or of the smoke test
    imports the third-party ``regex``."""
    forbidden = re.compile(r"^\s*(import|from)\s+regex(\.|\s|$)", re.M)
    files = sorted((ROOT / "rten_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert ROOT / "rten_tpu_torch" / "text" / "tokenizer.py" in files
    for f in files:
        assert not forbidden.search(f.read_text()), f"{f} imports regex"


def test_loads_an_onnx_file_without_flatbuffers_ml_dtypes_or_onnx(tmp_path):
    """The card machine has no flatbuffers, ml_dtypes or onnx: with the
    three blocked from import, the package imports whole and
    ``Model.load_file`` loads and runs an ONNX file of f32 tensors."""
    sys.path.insert(0, str(ROOT / "tests"))
    import gpt2_onnx

    shape = gpt2_onnx.GPT2Shape(vocab_size=64, n_positions=16, n_embd=32, n_layer=1, n_head=2)
    path = gpt2_onnx.export(gpt2_onnx.GPT2Module(shape), tmp_path / "m.onnx", seq=4)
    code = (
        "import sys\n"
        "for name in ('flatbuffers', 'ml_dtypes', 'onnx'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, numpy as np\n"
        "import rten_tpu_torch\n"
        "for m in pkgutil.walk_packages(rten_tpu_torch.__path__, 'rten_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rten_tpu_torch.model import Model\n"
        f"m = Model.load_file({str(path)!r}, device='cpu')\n"
        "out = m.run({'input_ids': np.array([[1, 2, 3]], np.int32)})[0]\n"
        "assert out.shape == (1, 3, 64), out.shape\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_no_card_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


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
