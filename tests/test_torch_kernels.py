"""The helpers of the port's card scripts that run without a card: the
``-Xptxas -v`` report that ``chip_smoke.py`` prints and checks for spills
in the Hopper attention kernels, the anchors by which ``chip_diag.py bwd``
instruments the attention source, the names ``chip_diag.py`` gives the
builds it compares, and the device busy time that ``chip_smoke.py
--profile`` reads from a trace."""
import importlib.util
import os

from mxnet_tpu_torch import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the shape of nvcc's output for two kernels of csrc/flash_attention.cu
LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__d6dda66b_18_flash_attention_cu_4ab7999319flash_bwd_kv_hopperILi64ELi64ELi3ELi2EEEvNS_9HopperBwdE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__d6dda66b_18_flash_attention_cu_4ab7999319flash_bwd_kv_hopperILi64ELi64ELi3ELi2EEEvNS_9HopperBwdE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 186 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__d6dda66b_18_flash_attention_cu_4ab7999319flash_bwd_delta_f32EPKfS1_Pfxi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__d6dda66b_18_flash_attention_cu_4ab7999319flash_bwd_delta_f32EPKfS1_Pfxi
    8 bytes stack frame, 8 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 28 registers, used 0 barriers
"""


def test_ptxas_report_reads_registers_and_spills_by_kernel():
    assert kernels.ptxas_report(LOG) == [
        {"kernel": "flash_bwd_kv_hopper<64,64,3,2>", "registers": 186,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "flash_bwd_delta_f32", "registers": 28,
         "spill_stores": 8, "spill_loads": 20}]


def test_kernel_names_from_plain_and_nested_symbols():
    assert kernels._kernel_name("_Z13layernorm_fwdILin3EEvPf") == \
        "layernorm_fwd<-3>"
    assert kernels._kernel_name("_ZN2ns6kernelEv") == "kernel"
    assert kernels._kernel_name("not_mangled") == "not_mangled"
    assert kernels.ptxas_report("") == []


def _chip_diag():
    spec = importlib.util.spec_from_file_location(
        "chip_diag", os.path.join(REPO, "chip_diag.py"))
    diag = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(diag)
    return diag


def test_bwd_diagnostic_anchors_match_the_source():
    """``chip_diag.py bwd`` instruments a copy of the attention source by
    anchored edits: each anchor must occur there exactly once."""
    diag = _chip_diag()
    with open(os.path.join(kernels.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    for old, _ in diag._INSTRUMENT + diag._MASKED_LOOP:
        assert src.count(old) == 1, old


def test_diagnostic_builds_are_named_in_the_order_given():
    """``chip_diag.py fwd`` and ``ln`` build this checkout's source as
    ``this`` and each ``--other`` file as ``other``, ``other2``, ..."""
    diag = _chip_diag()
    assert diag._other_sources("a.cu", []) == {"this": "a.cu"}
    assert list(diag._other_sources("a.cu", ["b.cu", "c.cu"]).items()) == [
        ("this", "a.cu"), ("other", "b.cu"), ("other2", "c.cu")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_device_busy_time_counts_overlapping_spans_once():
    """A kernel launched as a programmatic dependent starts its span while
    the one before it still runs: the busy time is the spans' union."""
    smoke = _chip_smoke()
    assert smoke.covered_ms([]) == 0.0
    assert smoke.covered_ms([(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]) == \
        0.03
    assert smoke.covered_ms(iter([(0.0, 50.0), (10.0, 20.0)])) == 0.05
    assert smoke.covered_ms([(2.0, 3.0), (0.0, 1.0), (1.0, 2.0)]) == 0.003
