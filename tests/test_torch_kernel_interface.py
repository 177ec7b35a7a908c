"""CPU checks of the port's kernel interface that only the card would
otherwise show: the ctypes argtypes of every C entry point of every
``csrc/*.cu`` against its signature in the source (a wrong one passes a
64-bit pointer as a 32-bit int), the rebuild rule of ``kernels/build.py``
when a header changes, and the bf16 kernels' 16-byte alignment check.  No
nvcc and no card needed.
"""

from __future__ import annotations

import ctypes
import os
import re

import pytest
import torch

from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.ops import adam
from neuralnetworklibrary_tpu_torch.ops import cross_entropy as ce
from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
from neuralnetworklibrary_tpu_torch.ops import lstm_scan as ls
from neuralnetworklibrary_tpu_torch.ops import paged_attention as pa

_SOURCE = build.CSRC / "flash_attention.cu"


def _c_signatures(path):
    """{name: (argument kinds, return kind)} of the functions inside the
    ``extern "C"`` block of a CUDA source; an argument's kind is "pointer",
    "int" or "float", a return's "int", "void" or "char*"."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    sigs = {}
    for ret, name, params in re.findall(
            r"^(int|void|const char\*)\s+(nnl_\w+)\(([^)]*)\)\s*\{", block,
            flags=re.M):
        kinds = []
        for param in " ".join(params.split()).split(","):
            if "*" in param:
                kinds.append("pointer")
            elif re.match(r"(const\s+)?int\s+\w+$", param.strip()):
                kinds.append("int")
            elif re.match(r"(const\s+)?float\s+\w+$", param.strip()):
                kinds.append("float")
            else:
                raise AssertionError(f"{name}: unparsed parameter {param!r}")
        sigs[name] = (kinds, {"const char*": "char*"}.get(ret, ret))
    return sigs


# the ctypes table of each csrc/*.cu
_TABLES = {"adam": adam.SIGNATURES, "cross_entropy": ce.SIGNATURES,
           "flash_attention": fa.SIGNATURES,
           "lstm_scan": ls.SIGNATURES, "paged_attention": pa.SIGNATURES}
_C = {source: _c_signatures(build.CSRC / f"{source}.cu")
      for source in build.sources()}
_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float", ctypes.c_char_p: "char*", None: "void"}


@pytest.mark.parametrize("source", build.sources())
def test_every_entry_point_has_a_table_row(source):
    assert _C[source], "no extern \"C\" functions parsed"
    assert sorted(_C[source]) == sorted(_TABLES[source])


@pytest.mark.parametrize("source, name", [
    (source, name) for source in build.sources()
    for name in sorted(_C[source])])
def test_argtypes_match_the_c_signature(source, name):
    kinds, ret = _C[source][name]
    argtypes, restype = _TABLES[source][name]
    assert [_KIND[t] for t in argtypes] == kinds
    assert _KIND[restype] == ret


def test_signature_parser_reads_each_kind(tmp_path):
    # the parser itself, on a source written for the purpose
    path = tmp_path / "probe.cu"
    path.write_text('extern "C" {\nint nnl_x(const void* a, int n,\n'
                    '          float r, void* stream) {\n  return 0;\n}\n'
                    'const char* nnl_y(int e) {\n  return 0;\n}\n'
                    'void nnl_z(int* out) {\n}\n}\n')
    assert _c_signatures(path) == {
        "nnl_x": (["pointer", "int", "float", "pointer"], "int"),
        "nnl_y": (["int"], "char*"), "nnl_z": (["pointer"], "void")}


def _touch(path, t):
    path.write_text(path.name)
    os.utime(path, (t, t))


@pytest.mark.parametrize("case, stale", [
    ("missing", True), ("fresh", False), ("source_newer", True),
    ("header_newer", True), ("other_header_newer", True)])
def test_stale_follows_source_and_headers(tmp_path, case, stale):
    src, so = tmp_path / "k.cu", tmp_path / "libk.so"
    _touch(src, 1000)
    _touch(tmp_path / "a.cuh", 1000)
    _touch(tmp_path / "b.cuh", 1000)
    if case != "missing":
        _touch(so, 2000)
    if case == "source_newer":
        _touch(src, 3000)
    if case == "header_newer":
        _touch(tmp_path / "a.cuh", 3000)
    if case == "other_header_newer":
        _touch(tmp_path / "b.cuh", 3000)
    assert build.stale(so, src) is stale


def test_csrc_headers_exist_for_the_rule():
    assert (build.CSRC / "hopper.cuh").is_file()
    assert '#include "hopper.cuh"' in _SOURCE.read_text()


@pytest.mark.parametrize("offset, ok", [(0, True), (8, True), (1, False),
                                        (4, False)])
def test_bf16_tensors_must_be_16_byte_aligned(offset, ok):
    base = torch.zeros(4096, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    t = base[offset:offset + 64]
    named = {"q": t, "lse": torch.zeros(4)}
    if ok:
        fa._check(named, torch.bfloat16, t.device)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            fa._check(named, torch.bfloat16, t.device)


def test_float32_tensors_need_no_16_byte_alignment():
    t = torch.zeros(65)[1:]
    fa._check({"q": t}, torch.float32, t.device)


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__545b394d_18_flash_attention_cu_7c4e5d3e19flash_fwd_tc_kernelILi64ELi64ELi3ELb0EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16PfiiNS_4OptsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__545b394d_18_flash_attention_cu_7c4e5d3e19flash_fwd_tc_kernelILi64ELi64ELi3ELb0EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16PfiiNS_4OptsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__545b394d_18_flash_attention_cu_7c4e5d3e20flash_bwd_dkv_kernelI13__nv_bfloat16Li128ELb1EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiNS_4OptsE' for 'sm_90a'
ptxas info    : Function properties for x
    56 bytes stack frame, 92 bytes spill stores, 84 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__545b394d_18_flash_attention_cu_7c4e5d3e16flash_fwd_kernelIfLi64ELb0EEEvPKT_S3_S3_PS1_PfiiNS_4OptsE' for 'sm_90a'
ptxas info    : Used 101 registers
"""


def test_ptxas_report_names_each_kernel():
    import chip_smoke

    assert chip_smoke.ptxas_report(_PTXAS_LOG) == {
        "flash_fwd_tc_kernel<64,64,3,false>": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0},
        "flash_bwd_dkv_kernel<bf16,128,true>": {
            "registers": 166, "spill_stores": 92, "spill_loads": 84},
        "flash_fwd_kernel<f32,64,false>": {"registers": 101}}


@pytest.mark.parametrize("mangled, name", [
    ("_Z16drop_keep_kernelPKiiiiiiifPh", "drop_keep_kernel"),
    ("_ZN12_GLOBAL__N_115lstm_fwd_kernelEPK13__nv_bfloat16",
     "lstm_fwd_kernel"),
    ("not_mangled", "not_mangled")])
def test_kernel_name_of_plain_and_unmangled_names(mangled, name):
    import chip_smoke

    assert chip_smoke.kernel_name(mangled) == name
