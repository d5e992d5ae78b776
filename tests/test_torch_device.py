"""The seam between Python and the CUDA kernels (``vkrt_tpu_torch/device.py``)
on the CPU: every C entry point of ``csrc/*.cu`` takes the arguments
``device.py`` binds; ``counts`` has one row for each launching entry point
and for kernel B's albedo instantiation, and ``reset_counts`` zeroes it;
``check_args`` refuses dtypes before shapes, layouts and devices,
``check_tensors`` the same without the device. The launches themselves
run only on the card."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from vkrt_tpu_torch import device as kdev

CSRC = Path(kdev.__file__).resolve().parent / "csrc"

# what each ctypes type of a binding is declared as in C
C_TYPES = {
    ctypes.c_void_p: ("const void*", "void*"),
    ctypes.c_int: ("int ",),
    ctypes.c_int64: ("int64_t ",),
    ctypes.c_float: ("float ",),
    ctypes.c_uint32: ("unsigned int ",),
    ctypes.POINTER(ctypes.c_int): ("int*",),
}


def _c_params(name: str) -> list:
    src = "\n".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    found = re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert len(found) == 1, name
    return [" ".join(p.split()) for p in found[0].split(",")]


@pytest.mark.parametrize("entry", sorted(kdev._SIGNATURES))
def test_entry_points_match_their_bindings(entry):
    """Each C entry point takes as many parameters as ``device.py`` binds,
    each of the bound type (a wrong width would cut an argument), the
    stream last where it launches."""
    params = _c_params(entry)
    bound = kdev._SIGNATURES[entry]
    assert len(params) == len(bound)
    for p, t in zip(params, bound):
        assert p.startswith(C_TYPES[t]), (p, t)
    assert (params[-1] == "void* stream") == (entry in kdev.counts)


def test_counts_and_reset():
    """One row for every launching entry point (no ``*_info`` query) and
    one for kernel B's albedo instantiation; ``reset_counts`` zeroes every
    row in place, so a reader holding the table sees it."""
    assert set(kdev.counts) == {e for e in kdev._SIGNATURES if not e.endswith("_info")} | {
        kdev.SHADE_ALBEDO}
    assert len(kdev.counts) == 14
    table = kdev.counts
    table["vkrt_trace"]["launches"] += 2
    table["vkrt_tex_aniso"]["lanes"] += 7
    kdev.reset_counts()
    assert kdev.counts is table
    assert all(c == {"launches": 0, "lanes": 0} for c in table.values())


def test_check_args_order():
    """Every dtype before any shape or layout, every layout before the
    device; a shape entry None takes any length; a strided name is let
    through; nothing on the CPU passes."""
    x = torch.zeros((6, 3))
    i = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError, match="i is torch.int32, want int64 or float32"):
        kdev.check_args("k", [("x", x[:2], torch.float32, (6, 3)),
                              ("i", i, (torch.int64, torch.float32), (6,))])
    with pytest.raises(ValueError, match=r"x is \(2, 3\), want \(6, 3\)"):
        kdev.check_args("k", [("x", x[:2], torch.float32, (6, 3))])
    with pytest.raises(ValueError, match=r"want \(\*, 4\)"):
        kdev.check_args("k", [("x", x, torch.float32, (None, 4))])
    with pytest.raises(ValueError, match="x must be contiguous"):
        kdev.check_args("k", [("x", x.t(), torch.float32, (3, 6))])
    for want, strided in (([("x", x, torch.float32, (None, 3))], ()),
                          ([("x", x.t(), torch.float32, None)], ("x",)),
                          ([], ())):
        with pytest.raises(ValueError, match="cpu is not a CUDA device"):
            kdev.check_args("k", want, device="cpu", strided=strided)
        kdev.check_tensors("k", want, strided=strided)
