"""`chip_smoke.py`'s kernel kinds, which split the device time under
``--profile``: every ``__global__`` kernel of the port's CUDA sources maps to
one of the port's own kinds, never to a library kind ("convs", "matmuls",
...) or to "elementwise and other"; and every kernel that the smoke reports
names a source that defines C entries and names that kernel.

`chip_smoke` imports only the standard library and numpy at its top, so
this runs without a card.
"""

import importlib.util
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "voicesplit_tpu_torch" / "csrc"

_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# `__global__ void [__launch_bounds__(...)] name(`, the name on the same line
# or the next
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(")


def global_names(text: str) -> list:
    return GLOBAL.findall(text)


GLOBALS = sorted({name for src in sorted(CSRC.glob("*.cu*")) for name in global_names(src.read_text())})
PORT_KINDS = {kind for kind, _ in chip_smoke.PORT_KERNEL_KINDS}


def test_the_parser_reads_launch_bounds_and_a_name_on_the_next_line():
    text = """
template <typename T, int KF>
__global__ void __launch_bounds__(kThreads, 1)
conv_a_kernel(const T* x) {}
__global__ void reduce_b_kernel(float* out) {}
__global__ void __launch_bounds__(256) c_kernel
    (int n) {}
"""
    assert global_names(text) == ["conv_a_kernel", "reduce_b_kernel", "c_kernel"]
    assert len(GLOBALS) >= 10  # the LSTM and conv kernels and their reductions


@pytest.mark.parametrize("name", GLOBALS)
def test_every_port_kernel_maps_to_a_port_kind(name):
    """As the profiler names them: demangled with the anonymous namespace,
    the template arguments and the parameters."""
    for shown in (name, f"void (anonymous namespace)::{name}<__nv_bfloat16>(__nv_bfloat16 const*, int)",
                  f"void (anonymous namespace)::{name}<float, 5>(float const*, float*, FwdWork)"):
        assert chip_smoke.kernel_kind(shown) in PORT_KINDS, shown


@pytest.mark.parametrize("shown,kind", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convs"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)", "convs"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "matmuls"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma", "matmuls"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "optimizer"),
    ("void at::native::elementwise_kernel<128, 2, ...>", "elementwise and other"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collectives"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclDevComm*, unsigned long, ncclWork*)", "collectives"),
])
def test_library_kernels_keep_their_kinds(shown, kind):
    assert chip_smoke.kernel_kind(shown) == kind


@pytest.mark.parametrize("kernel", sorted(chip_smoke.SOURCES))
def test_each_reported_kernel_names_its_source(kernel):
    src = REPO / chip_smoke.SOURCES[kernel]
    assert src.is_file(), src
    text = src.read_text()
    assert 'extern "C" int' in text and re.search(rf"\b{kernel}\b", text), (kernel, src)
    assert kernel in chip_smoke.REPLACES
