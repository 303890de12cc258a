"""Reading the port's CUDA sources from the CPU tests: the constants and
launch-plan structs that the Python wrappers mirror.  On the card each
wrapper checks its mirror against the compiled library; these checks let
the CPU tests see a mirror that drifted from its source."""
import ctypes
import re
from pathlib import Path

CSRC = (Path(__file__).resolve().parent.parent / "cp_pfdr_graph_d1_tpu_torch"
        / "csrc")
_CTYPES = {"int": ctypes.c_int, "double": ctypes.c_double,
           "long long": ctypes.c_longlong}


def cuda_source(name):
    """The text of ``csrc/name`` and of the shared header it includes."""
    return (CSRC / name).read_text() + (CSRC / "pfdr_common.cuh").read_text()


def cuda_constant(src, name):
    """The integer value of ``name = value`` (a constexpr or an enum
    member) in ``src``."""
    m = re.search(r"\b%s\s*=\s*(\d+)" % re.escape(name), src)
    assert m, f"{name} not found in the CUDA source"
    return int(m.group(1))


def cuda_struct(src, name):
    """A ctypes Structure laid out as the C struct ``name`` of ``src``
    (fields of type int, long long, double or a pointer, const or not;
    arrays sized by a constant of the source)."""
    m = re.search(r"struct\s+%s\s*\{(.*?)\};" % re.escape(name), src, re.S)
    assert m, f"struct {name} not found in the CUDA source"
    body = re.sub(r"//[^\n]*", "", m.group(1))
    fields = []
    for decl in filter(None, (d.strip().removeprefix("const ")
                              for d in body.split(";"))):
        kind = next(k for k in ("long long", "void", "int", "double")
                    if decl.startswith(k))
        rest = decl[len(kind):]
        for d in (x.strip() for x in rest.split(",")):
            ptr = d.startswith("*")
            dm = re.fullmatch(r"\*?\s*(\w+)(?:\[(\w+)\])?", d)
            assert dm, f"cannot read the declarator {d!r} of {name}"
            ct = ctypes.c_void_p if ptr else _CTYPES[kind]
            if dm.group(2):
                ct = ct * cuda_constant(src, dm.group(2))
            fields.append((dm.group(1), ct))
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def assert_struct_mirrors(src, name, mirror):
    """``mirror`` (a ctypes Structure) has the fields of the C struct
    ``name``, in order, at the same offsets and sizes, and its size."""
    c = cuda_struct(src, name)
    names = [f[0] for f in c._fields_]
    assert [f[0] for f in mirror._fields_] == names
    for n in names:
        a, b = getattr(c, n), getattr(mirror, n)
        assert (a.offset, a.size) == (b.offset, b.size), n
    assert ctypes.sizeof(c) == ctypes.sizeof(mirror)
