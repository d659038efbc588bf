"""The ctypes signatures in ``repro_torch.kernels._build`` against the C
interface the CUDA sources declare.  A C function whose arguments drift
from its ``ctypes`` signature corrupts memory without an error, so each
``extern "C"`` function of each ``csrc/*.cu`` is held to its entry in
``SIGNATURES``: name, argument count, and a pointer, ``int`` or
``size_t`` in each place (and the return type).  Also: the constants the
tuning tools vary exist, and each piece of shared kernel code is defined
in one file under ``csrc/``.  Runs on the CPU: it reads the sources and
never builds them."""

import ctypes
import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.kernels import _build, ops

_C_TYPES = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
            "size_t": ctypes.c_size_t, "const char*": ctypes.c_char_p}


def _kind(decl: str) -> str:
    """'pointer', 'int', 'size_t' or 'const char*' for a C parameter or
    return type (the parameter's name, if any, included)."""
    decl = " ".join(decl.split())
    if decl.startswith("const char*"):
        return "const char*"
    if "*" in decl:
        return "pointer"
    base = decl.split()[0]
    if base in ("int", "size_t"):
        return base
    raise ValueError(f"unexpected C type in {decl!r}")


def extern_c_functions(source: str) -> dict:
    """{name: (return kind, [parameter kinds])} of the functions defined
    in the ``extern "C" { ... }`` blocks of a CUDA source."""
    source = re.sub(r"//[^\n]*", "", source)
    out = {}
    for start in re.finditer(r'extern "C" \{', source):
        depth, i = 1, start.end()
        while depth:                       # to the block's closing brace
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            i += 1
        block = source[start.end():i - 1]
        for f in re.finditer(r"^([A-Za-z_][\w \t\*]*?[ \t\*])(\w+)\("
                             r"([^)]*)\)\s*\{", block, re.M):
            params = [p for p in f.group(3).split(",") if p.strip()]
            out[f.group(2)] = (_kind(f.group(1)), [_kind(p) for p in params])
    return out


def _declared(name: str) -> dict:
    return extern_c_functions((_build.CSRC / f"{name}.cu").read_text())


def test_sources_are_the_csrc_files():
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(_build.SIGNATURES) == set(_build.SOURCES)


@pytest.mark.parametrize("name", _build.SOURCES)
def test_extern_c_names_match_signatures(name):
    assert set(_declared(name)) == set(_build.SIGNATURES[name])


@pytest.mark.parametrize("name,fn", [(n, f) for n in _build.SOURCES
                                     for f in _build.SIGNATURES[n]])
def test_extern_c_arguments_match_signature(name, fn):
    ret, params = _declared(name)[fn]
    argtypes, restype = _build.SIGNATURES[name][fn]
    assert len(params) == len(argtypes)
    assert [_C_TYPES[k] for k in params] == list(argtypes)
    assert _C_TYPES[ret] is restype


def test_parser_reads_declarations():
    src = '''
namespace { int helper(int x) { return x; } }
extern "C" {
// a comment (with parentheses)
size_t f_bytes(int quant, int CB) { return 0; }
int f_launch(const void* a, void* b,
             int n, size_t m, void* stream) {
  return helper(n);
}
const char* f_error_string(int err) { return ""; }
}  // extern "C"
'''
    assert extern_c_functions(src) == {
        "f_bytes": ("size_t", ["int", "int"]),
        "f_launch": ("int", ["pointer", "pointer", "int", "size_t",
                             "pointer"]),
        "f_error_string": ("const char*", ["int"]),
    }


def test_with_constants_replaces_first_definition():
    src = ("constexpr int kThreads = 128;  // a block\n"
           "constexpr int kWarps = kThreads / 32;\n")
    out = _build.with_constants(src, "kThreads=256, kWarps = 4")
    assert out == ("constexpr int kThreads = 256;  // a block\n"
                   "constexpr int kWarps = 4;\n")
    with pytest.raises(ValueError):
        _build.with_constants(src, "kMissing=1")


def test_lut_build_constants_can_vary():
    """The constants the LC bench tool varies exist in the source."""
    src = (_build.CSRC / "lut_build.cu").read_text()
    for spec in ("kThreads=256", "kStreamStores=0", "kRowsF32=1",
                 "kRowsU8=1", "kStageDsub=16", "kMinBlocks=4"):
        assert _build.with_constants(src, spec) != src


def test_lut_bench_probes_apply_to_the_source():
    """Each diagnostic build of tools/torch_lut_build_bench.py finds what
    it edits in csrc/lut_build.cu."""
    spec = importlib.util.spec_from_file_location(
        "torch_lut_build_bench",
        Path(__file__).resolve().parents[1] / "tools"
        / "torch_lut_build_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    src = (_build.CSRC / "lut_build.cu").read_text()
    for name in bench.PROBES:
        assert bench.probe_source(src, name) != src


@pytest.mark.parametrize("spec", ["kWarps=8", "kUnroll=4", "kInsertMax=8",
                                  "kMaxMergeKeys=1024"])
def test_ts_topk_constants_can_vary(spec):
    """The tuning handles of TS by slot exist in its source."""
    src = (_build.CSRC / "ts_topk.cu").read_text()
    assert _build.with_constants(src, spec) != src


def _defines(text: str, kind: str, name: str) -> bool:
    """Whether CUDA source ``text`` defines the function or the constant
    ``name`` (kind "function" / "constant"), or calls ``name`` ("call")."""
    text = re.sub(r"//[^\n]*", "", text)
    if kind == "constant":
        return re.search(rf"\bconstexpr [\w ]+ {name} =", text) is not None
    if kind == "call":
        return re.search(rf"\b{name}\s*\(", text) is not None
    # a return type (not a statement's keyword) before the name, then a body
    return re.search(rf"^[ \t]*(?!return\b|else\b)(?:[\w:]+[ \t]+)+[*&]?"
                     rf"{name}[ \t]*\([^;{{]*\)\s*\{{", text,
                     re.M) is not None


_SHARED = ([("function", n) for n in (
    "ordered_bits", "from_ordered", "make_key", "key_dist", "kmin", "kmax",
    "warp_sort32", "bitonic_merge", "merge32", "insert1", "kth",
    "keys_per_lane", "k_pad_of", "slot_rows", "task_rows",
    "resident_blocks")]
    + [("constant", n) for n in ("kAll", "kNone", "kNone32",
                                 "kMaxRowsKey32", "kMaxKPad", "kMaxDevices")]
    + [("call", "cudaOccupancyMaxActiveBlocksPerMultiprocessor")])


@pytest.mark.parametrize("kind,name", _SHARED)
def test_shared_kernel_code_is_written_once(kind, name):
    """Each piece of the kernels' shared machinery (the warp top-k and its
    k_pad rules, the slot convention, the resident-grid lookup) lives in
    one file under csrc/."""
    files = sorted(f.name for f in _build.CSRC.iterdir()
                   if f.suffix in (".cu", ".cuh")
                   and _defines(f.read_text(), kind, name))
    assert len(files) == 1, files


@pytest.mark.parametrize("py,cpp", [("MAX_K_PAD", "kMaxKPad"),
                                    ("BF16_KEY32_MAX_C", "kMaxRowsKey32")])
def test_ops_limits_equal_the_warp_topk_header(py, cpp):
    """The wrapper refuses what the kernels refuse: its limits are the
    selection header's."""
    text = (_build.CSRC / "warp_topk.cuh").read_text()
    value = re.search(rf"\bconstexpr [\w ]+ {cpp} = (\w+);", text).group(1)
    assert getattr(ops, py) == int(value, 0)


def test_defines_tells_a_definition_from_a_use():
    src = ("template <int KPL, typename Key>\n"
           "__device__ __forceinline__ void insert1(Key (&v)[KPL], Key x,\n"
           "                                        int lane) {\n"
           "}\n"
           "inline int keys_per_lane(int kp) { return kp; }\n"
           "constexpr unsigned kAll = 0xffffffffu;\n")
    uses = ("  insert1<KPL>(v, x, lane);\n"
            "  return keys_per_lane(kp);\n"
            "  if (keys_per_lane(kp) > 1) {\n"
            "  x = kAll;  // constexpr unsigned kAll = 0;\n")
    for kind, name in (("function", "insert1"), ("function", "keys_per_lane"),
                       ("constant", "kAll")):
        assert _defines(src, kind, name)
        assert not _defines(uses, kind, name)
    assert _defines(uses, "call", "keys_per_lane")
    assert not _defines(uses, "call", "insert1")


def _fused_bench():
    spec = importlib.util.spec_from_file_location(
        "torch_fused_topk_bench",
        Path(__file__).resolve().parents[1] / "tools"
        / "torch_fused_topk_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("spec", ["kThreadsF32=128", "kThreadsU8=64",
                                  "kThreadsBF16=32", "kThreadsBF16=128",
                                  "kInsertMax=4"])
def test_fused_topk_constants_can_vary(spec):
    """The constants the fused bench tool varies exist in the source."""
    src = (_build.CSRC / "pq_scan_topk.cu").read_text()
    assert _build.with_constants(src, spec) != src


@pytest.mark.parametrize("name", ["conflict-free", "no-selection",
                                  "pre-staged"])
def test_fused_bench_probes_apply_to_the_sources(name):
    """Each diagnostic build of tools/torch_fused_topk_bench.py finds what
    it edits in csrc/ (every pattern at least once)."""
    bench = _fused_bench()
    edited = bench.probe_sources(name)
    assert edited
    for fname, text in edited.items():
        assert text != (_build.CSRC / fname).read_text()


def _template_params(source: str, kernel: str) -> list:
    """The template parameter lists of each ``__global__`` definition of
    ``kernel`` in a CUDA source, one list of "type name" strings each."""
    text = re.sub(r"//[^\n]*", "", source)
    found = re.findall(rf"template\s*<([^<>]*)>\s*__global__[^;{{]*?"
                       rf"\b{kernel}\s*\(", text)
    return [[" ".join(p.split()) for p in f.split(",")] for f in found]


class _MetricCtx:
    """What a DC roofline reader takes: a trace, a window, the cell's
    index shape and the rows it scanned."""

    def __init__(self, trace):
        from types import SimpleNamespace
        self.trace = trace
        self.window = SimpleNamespace(answered=256)
        self.cell = SimpleNamespace(config={
            "service": {"index": {"m": 16, "cb": 256}, "nprobe": 96}})

    def scanned_rows(self) -> int:
        return 256 * 96 * 1526


def test_pq_scan_kernel_names_keep_the_dc_metrics_reading():
    """Kernel C's instances, named as the profiler names them, are read
    as C by ``dc_roofline.batch`` (the name ``pq_scan_kernel``) and as D by
    ``dc_u8_roofline.batch`` (the table kind 1 as the second template
    argument, a third one after it) and by no top-k metric.  So a change
    to the kernel's name or its leading ``<CodeT, kKind`` parameters fails
    here, not as a null metric on the card."""
    import sys
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from annbench import harness, trace
    params = _template_params((_build.CSRC / "pq_scan.cu").read_text(),
                              "pq_scan_kernel")
    assert len(params) == 2                        # dense and by slot
    for p in params:
        assert p[:2] == ["typename CodeT", "int kKind"] and len(p) >= 3, p
    rest = ", ".join(["true"] * (len(params[0]) - 2))
    for code in ("unsigned char", "int"):
        for kind, value in ops._KIND.items():
            name = (f"void (anonymous namespace)::pq_scan_kernel<{code}, "
                    f"{value}, {rest}>(void const*, float const*, float "
                    f"const*, {code} const*, int const*, float*, int, int, "
                    f"int, int)")
            ctx = _MetricCtx(trace.Trace(1.0, 1.0,
                                         kernels={name: (1, 1e-3)}))
            read = {m: harness.reader(m, root)(ctx) for m in (
                "dc_roofline.batch", "dc_u8_roofline.batch",
                "topk_share.batch")}
            assert read["dc_roofline.batch"] is not None, name
            assert (read["dc_u8_roofline.batch"] is not None) == \
                (kind == "u8"), name
            assert read["topk_share.batch"] == 0.0, name


def test_dc_layout_bench_edits_apply_to_the_source():
    """The layouts and constants tools/torch_dc_layout_bench.py times
    against the source find what they edit in csrc/pq_scan.cu."""
    spec = importlib.util.spec_from_file_location(
        "torch_dc_layout_bench",
        Path(__file__).resolve().parents[1] / "tools"
        / "torch_dc_layout_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    src = (_build.CSRC / "pq_scan.cu").read_text()
    for name in bench.PROBES:
        assert bench.probe_source(name) != src
    assert _build.with_constants(src, "kThreads=128") != src
