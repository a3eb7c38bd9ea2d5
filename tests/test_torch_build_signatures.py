"""The ctypes signatures ``kernels/_build.py`` declares for the port's CUDA
libraries, held against the ``extern "C"`` declarations in ``csrc/``: a
missing or extra argument would shift every later one (a stream pointer
cut to an int), which only a card run would show, as a crash. CPU only:
the sources are read as text."""

import ctypes
import re

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.kernels import _build

_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong}


def _declared(lib: str) -> dict:
    """C function -> argument types, from csrc/<lib>.cu."""
    text = (_build.CSRC / f"{lib}.cu").read_text()
    funcs = {}
    for name, params in re.findall(r'extern "C" int (tux_\w+)\(([^)]*)\)',
                                   text):
        types = []
        for p in params.split(","):
            decl = " ".join(p.split()[:-1]).replace("const ", "")
            star = "*" if "*" in p else ""
            types.append(_TYPES[decl.replace("*", "").strip() + star])
        funcs[name] = types
    return funcs


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_declarations(lib):
    assert _declared(lib) == {fn: list(types) for fn, types
                              in _build.SIGNATURES[lib].items()}
