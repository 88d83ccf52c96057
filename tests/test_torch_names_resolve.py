"""Every global name that a function of the port's kernel wrappers, ops,
tools and host libraries (text, native, generate, ctc, imageproc,
imageio, functional) loads resolves in its module or in builtins.

The CPU tests run the wrappers' plain versions, never their CUDA launch
paths, so a helper deleted from a module (as a clean-up once deleted
``_ptr`` from ``kernels/flash_attention.py`` while the append and paged
wrappers still called it) would otherwise fail only on the card. Each
function's bytecode is read with the standard library's ``dis``: every
``LOAD_GLOBAL`` (in the function and in the functions and comprehensions
nested in it) must name something the module defines or imports, or a
builtin. One case per module.
"""

import builtins
import dis
import importlib
import inspect
import pathlib
import types

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "rten_tpu_torch"
MODULES = sorted(
    [f"rten_tpu_torch.{p.parent.name}.{p.stem}"
     for sub in ("kernels", "ops", "tools", "formats", "runtime", "text", "native", "generate")
     for p in (PORT / sub).glob("*.py")]
    + [f"rten_tpu_torch.{m}" for m in ("cli", "model", "optimize", "shape_inference",
                                       "serialize", "ctc", "imageproc", "imageio",
                                       "functional")])


def _functions(module):
    """The module's own functions, and the methods of its own classes."""
    for obj in vars(module).values():
        obj = inspect.unwrap(obj) if callable(obj) else obj
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        if isinstance(obj, types.FunctionType):
            yield obj
        elif isinstance(obj, type):
            for attr in vars(obj).values():
                for fn in (attr, getattr(attr, "__func__", None), getattr(attr, "fget", None)):
                    if isinstance(fn, types.FunctionType):
                        yield fn


def _codes(code):
    yield code
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            yield from _codes(const)


def unresolved(module):
    """{(function, name)}: the global names the module's functions load that
    neither their globals (the module's, or a generated method's own) nor
    builtins define."""
    missing = set()
    for fn in _functions(module):
        for code in _codes(fn.__code__):
            for ins in dis.get_instructions(code):
                if ins.opname == "LOAD_GLOBAL" and ins.argval not in fn.__globals__ \
                        and not hasattr(builtins, ins.argval):
                    missing.add((fn.__qualname__, ins.argval))
    return missing


def test_the_port_has_modules_to_check():
    assert "rten_tpu_torch.kernels.flash_attention" in MODULES
    assert "rten_tpu_torch.tools.bench_decode_attn" in MODULES
    assert {"rten_tpu_torch.formats.rten", "rten_tpu_torch.cli",
            "rten_tpu_torch.ops.layout"} <= set(MODULES)
    assert {"rten_tpu_torch.text.tokenizer", "rten_tpu_torch.text.pattern",
            "rten_tpu_torch.native.__init__", "rten_tpu_torch.generate.text_decoder",
            "rten_tpu_torch.ctc", "rten_tpu_torch.imageproc", "rten_tpu_torch.imageio",
            "rten_tpu_torch.functional"} <= set(MODULES)


@pytest.mark.parametrize("name", MODULES)
def test_global_names_resolve(name):
    assert unresolved(importlib.import_module(name)) == set()


def test_a_deleted_helper_is_caught():
    """A synthetic module whose wrapper calls a helper, in a launch path
    no CPU test runs: it passes whole and fails with the helper deleted."""
    module = types.ModuleType("synthetic_wrappers")
    exec(
        "import math\n"
        "def _ptr(t):\n"
        "    return id(t)\n"
        "class Launcher:\n"
        "    def launch(self, t, on_card):\n"
        "        if on_card:\n"
        "            return [_ptr(x) for x in t]\n"
        "        return math.fsum(t)\n",
        vars(module),
    )
    assert unresolved(module) == set()
    del module._ptr
    assert unresolved(module) == {("Launcher.launch", "_ptr")}
