"""The copy probe K4 on the CPU: `copy` takes the plain version for a CPU
tensor and launches nothing, the kernel's wrapper refuses a CPU tensor,
and tools/bench_copy_torch.py refuses to run without a card (it reports a
device rate, which a CPU run cannot give). The kernel itself is held
exact on the card by tests/test_torch_kernels_cuda.py."""

import importlib.util
import os

import pytest
import torch

from sm3x_torch.ops import copy_cuda as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [1, 3, 4097])
def test_copy_on_cpu_is_a_clone(n):
    x = torch.randn(n)
    before = K.copy_cuda.launches
    y = K.copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert K.copy_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        K.copy_cuda(x)


def test_copy_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    spec = importlib.util.spec_from_file_location(
        "bench_copy_torch", os.path.join(ROOT, "tools", "bench_copy_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.raises(SystemExit, match="NVIDIA GPU"):
        tool.main(["1", "1"])
