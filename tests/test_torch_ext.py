"""The port's launch path (nomad_tpu_torch/_ext.py) on the CPU.

Every ``extern "C" int nt_*`` of ``nomad_tpu_torch/csrc/*.cu`` is parsed
and held against ``_ext._SIGNATURES``: its library, and its parameters'
count and kinds against the ctypes argtypes; every ``extern "C" long
long nt_*`` size query likewise against ``_ext._QUERIES``. A wrong argtypes list makes
ctypes pass a pointer as a 32-bit int, or shift every argument after it:
memory corruption on the card, which nothing here would show. Then
``entry`` and ``launch`` run on stub libraries and stub device
functions: each entry point is typed once, the device is switched only
when it must be, and the count is one a kernel launched.
"""

import ctypes
import re

import pytest
import torch

from nomad_tpu_torch import _ext

_DEF = re.compile(r'extern\s+"C"\s+int\s+(nt_\w+)\s*\(([^)]*)\)', re.S)
_QUERY = re.compile(r'extern\s+"C"\s+long\s+long\s+(nt_\w+)\s*\(([^)]*)\)',
                    re.S)


def c_entry_points(pattern=_DEF):
    """{name: (library, [parameter kinds])} of every C entry point (or,
    with ``_QUERY``, every size query)."""
    out = {}
    for path in sorted(_ext.CSRC.glob("*.cu")):
        for name, params in pattern.findall(path.read_text()):
            decls = [" ".join(p.split()) for p in params.split(",")]
            out[name] = (path.stem, [_c_kind(d, last=i == len(decls) - 1)
                                     for i, d in enumerate(decls)])
    return out


def _c_kind(decl, last):
    """A C parameter's kind: the trailing stream (or stream array), a
    pointer, int, float or uint32."""
    pname = decl.split()[-1].lstrip("*")
    if last and pname in ("stream", "streams") and "*" in decl:
        return "stream"
    if "*" in decl:
        return "pointer"
    ctype = " ".join(decl.split()[:-1]).replace("const ", "")
    return {"int": "int", "float": "float", "uint32_t": "uint32"}[ctype]


def argtype_kinds(argtypes):
    """The kinds of a ctypes argtypes list; its last entry is the
    trailing stream."""
    kinds = []
    for i, t in enumerate(argtypes):
        if t is ctypes.c_void_p or (isinstance(t, type)
                                    and issubclass(t, ctypes._Pointer)):
            kinds.append("stream" if i == len(argtypes) - 1 else "pointer")
        else:
            kinds.append({ctypes.c_int: "int", ctypes.c_float: "float",
                          ctypes.c_uint32: "uint32"}[t])
    return kinds


C_ENTRY_POINTS = c_entry_points()
C_QUERIES = c_entry_points(_QUERY)


def test_csrc_has_entry_points():
    assert len(C_ENTRY_POINTS) == len(_ext._SIGNATURES) >= 17


@pytest.mark.parametrize("name", sorted(_ext._SIGNATURES))
def test_signature_matches_its_c_definition(name):
    """Each _SIGNATURES entry has a C definition in the library it names,
    with the same parameter count and kinds, the stream last."""
    lib, argtypes = _ext._SIGNATURES[name]
    assert name in C_ENTRY_POINTS, f"{name} has no C definition"
    c_lib, c_kinds = C_ENTRY_POINTS[name]
    assert lib == c_lib
    assert argtype_kinds(argtypes) == c_kinds
    assert c_kinds[-1] == "stream"


def test_every_c_entry_point_has_a_signature():
    assert sorted(C_ENTRY_POINTS) == sorted(_ext._SIGNATURES)
    assert _ext.LIBRARIES == tuple(sorted(
        {lib for lib, _ in C_ENTRY_POINTS.values()}))


def test_every_c_size_query_has_a_signature():
    assert sorted(C_QUERIES) == sorted(_ext._QUERIES)
    assert not set(C_QUERIES) & set(C_ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(_ext._QUERIES))
def test_size_query_matches_its_c_definition(name):
    """Each size query lives in the library of the kernel it sizes and
    takes ints only, as many as its argtypes say."""
    lib, argtypes = _ext._QUERIES[name]
    c_lib, c_kinds = C_QUERIES[name]
    assert lib == c_lib
    assert argtype_kinds(argtypes) == c_kinds == ["int"] * len(c_kinds)
    assert name.replace("_scratch_words", "") in C_ENTRY_POINTS


@pytest.mark.parametrize("mutation", ["drop", "int_for_pointer",
                                      "float_for_int", "extra"])
def test_a_wrong_argtypes_list_is_caught(mutation):
    """The comparison above fails on each way an argtypes list can go
    wrong."""
    _, c_kinds = C_ENTRY_POINTS["nt_scatter_shards"]
    argtypes = list(_ext._SIGNATURES["nt_scatter_shards"][1])
    if mutation == "drop":
        del argtypes[4]
    elif mutation == "int_for_pointer":
        argtypes[0] = ctypes.c_int
    elif mutation == "float_for_int":
        argtypes[5] = ctypes.c_float
    else:
        argtypes.insert(4, ctypes.c_int)
    assert argtype_kinds(argtypes) != c_kinds


class _StubFn:
    """A C function of a stub library: counts its argtypes sets, returns
    ``code`` and keeps its calls."""

    def __init__(self):
        self.sets = 0
        self._argtypes = None
        self.restype = None
        self.code = 0
        self.calls = []

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _StubLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if not name.startswith("nt_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _StubFn())


@pytest.fixture
def stub_libs(monkeypatch):
    """Every library a stub, nothing typed yet, no build."""
    def no_build(names=None):
        raise AssertionError("build() called with every library loaded")

    monkeypatch.setattr(_ext, "_libs", {n: _StubLib()
                                        for n in _ext.LIBRARIES})
    monkeypatch.setattr(_ext, "_fns", {})
    monkeypatch.setattr(_ext, "build", no_build)
    return _ext._libs


def test_entry_types_each_function_once(stub_libs):
    for name, (lib, argtypes) in _ext._SIGNATURES.items():
        fn = _ext.entry(name)
        for _ in range(3):
            assert _ext.entry(name) is fn
        assert fn is stub_libs[lib].fns[name]
        assert fn.sets == 1
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int


def test_entry_types_each_size_query_once(stub_libs):
    for name, (lib, argtypes) in _ext._QUERIES.items():
        fn = _ext.entry(name)
        assert _ext.entry(name) is fn
        assert fn is stub_libs[lib].fns[name]
        assert fn.sets == 1
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_longlong


@pytest.mark.parametrize("query", sorted(_ext._QUERIES))
def test_scratch_words_asks_once_a_shape(stub_libs, query):
    """Each wrapper's scratch size comes from its library's query (B1's
    and B16's among them), one crossing a shape."""
    _ext.scratch_words.cache_clear()
    try:
        fn = _ext.entry(query)
        fn.code = 123
        sizes = (64,) + (4,) * (len(_ext._QUERIES[query][1]) - 1)
        for _ in range(3):
            assert _ext.scratch_words(query, *sizes) == 123
        _ext.scratch_words(query, 128, *sizes[1:])
        assert fn.calls == [sizes, (128,) + sizes[1:]]
    finally:
        _ext.scratch_words.cache_clear()


class _Cards:
    """Stub current-device functions: records device switches; stream
    handle 1000 + the card's index."""

    def __init__(self, current=0):
        self.current = current
        self.sets = []

    def get(self):
        return self.current

    def set(self, index):
        self.sets.append(index)
        self.current = index

    @staticmethod
    def stream(index):
        return 1000 + index


@pytest.fixture
def cards(monkeypatch):
    c = _Cards()
    monkeypatch.setattr(_ext, "_cuda_fns", (c.get, c.set, c.stream))
    return c


def _launches(name):
    return _ext.COUNTS.snapshot()["launches"][name]


def test_launch_on_the_current_card_switches_nothing(stub_libs, cards):
    fn = _ext.entry("nt_scatter_add")
    before = _launches("scatter_add")
    _ext.launch("scatter_add", torch.device("cuda", 0), fn, 1, 2, 3, 4, 4, 8)
    assert fn.calls == [(1, 2, 3, 4, 4, 8, 1000)]
    assert cards.sets == []
    assert _launches("scatter_add") == before + 1


def test_launch_on_a_device_with_no_index_uses_the_current_card(
        stub_libs, cards):
    cards.current = 2
    fn = _ext.entry("nt_scatter_add")
    before = _launches("scatter_add")
    _ext.launch("scatter_add", torch.device("cuda"), fn, 1, 2, 3, 4, 4, 8)
    assert fn.calls == [(1, 2, 3, 4, 4, 8, 1002)]   # card 2's stream
    assert cards.sets == [] and cards.current == 2
    assert _launches("scatter_add") == before + 1


def test_launch_on_another_card_switches_and_restores(stub_libs, cards):
    fn = _ext.entry("nt_scatter_add")
    _ext.launch("scatter_add", torch.device("cuda", 2), fn, 1, 2, 3, 4, 4, 8)
    assert fn.calls[-1][-1] == 1002          # card 2's stream
    assert cards.sets == [2, 0] and cards.current == 0


def test_launch_restores_the_card_when_the_call_raises(cards):
    def boom(*args):
        raise OSError("stub")

    with pytest.raises(OSError):
        _ext.launch("scatter_add", torch.device("cuda", 3), boom, 1)
    assert cards.current == 0


def test_launch_raises_on_an_error_and_counts_nothing(stub_libs, cards):
    fn = _ext.entry("nt_scatter_add")
    fn.code = 700
    before = _launches("scatter_add")
    with pytest.raises(RuntimeError, match="scatter_add launch: CUDA error "
                                           "700"):
        _ext.launch("scatter_add", torch.device("cuda", 0), fn, 1)
    assert _launches("scatter_add") == before


def test_launch_on_a_mesh_passes_every_stream(stub_libs, cards):
    """A mesh's device tuple: one host call, the shards' stream handles as
    the last argument, one count a shard, no switch on the host."""
    fn = _ext.entry("nt_scatter_shards")
    devices = tuple(torch.device("cuda", i) for i in (0, 1, 1, 3))
    before = _launches("scatter_shard")
    _ext.launch("scatter_shard", devices, fn, "u", "i", "d", "o", 4, 64, 8,
                0)
    (call,) = fn.calls
    assert call[:-1] == ("u", "i", "d", "o", 4, 64, 8, 0)
    assert list(call[-1]) == [1000, 1001, 1001, 1003]
    assert cards.sets == []
    assert _launches("scatter_shard") == before + 4
