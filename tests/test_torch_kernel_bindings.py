"""The ctypes bindings of the port's kernels against the C signatures of
their sources.

The kernels build and run only on a CUDA card, but the ``argtypes`` the
wrappers declare for each ``extern "C"`` entry point can be held to the
source here: one ctypes type per parameter, in order (``int64_t`` ->
``c_int64``, ``int`` -> ``c_int``, any pointer -> ``c_void_p``). A
parameter missing from the list would shift every later one at the call.
"""

import ctypes
import re

import pytest

from kubetpu_torch import kernels

_SIG = re.compile(r'extern "C" int (kt_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    out = {}
    for src in kernels.SOURCES:
        text = (kernels.CSRC / src).read_text()
        for name, params in _SIG.findall(text):
            out[name] = (src, [p.strip() for p in params.split(",")])
    return out


def _declared():
    out = {f"kt_{name}": types for name, types in kernels._ARGTYPES.items()}
    for entries in kernels._MORE_ENTRIES.values():
        out.update(entries)
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0].replace("const ", "").strip()
    return {"int64_t": ctypes.c_int64, "int": ctypes.c_int}[kind]


ENTRIES = _entry_points()


def test_every_entry_point_is_declared():
    assert set(ENTRIES) == set(_declared())


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_argtypes_match_the_source(name):
    src, params = ENTRIES[name]
    assert _declared()[name] == [_ctype(p) for p in params], src


# parameters added to existing entry points, each just before the stream:
# the pod classes of filter_score's two entries, and K4's host word pair
ADDED = {
    "kt_filter_score": ["const void* reps", "const void* rep_of", "int64_t C"],
    "kt_filter_score_shard": ["const void* reps", "const void* rep_of", "int64_t C"],
    "kt_shard_argmax": ["void* host_out"],
}


@pytest.mark.parametrize("name", sorted(ADDED))
def test_added_parameters_precede_the_stream(name):
    _, params = ENTRIES[name]
    assert params[-1] == "void* stream"
    assert params[-1 - len(ADDED[name]):-1] == ADDED[name]
    assert _declared()[name][-1 - len(ADDED[name]):] == [
        _ctype(p) for p in ADDED[name] + ["void* stream"]]
