"""The CUDA kernels against their plain PyTorch versions on the card, and
their wrappers' refusal of CPU tensors. Imports no jax, so it also runs on
a machine with a card and no jax:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gemm.kernel import gemm_cuda
from repro_torch.kernels.gemm.ref import gemm_ref

FLASH_VARIANTS = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=37),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=17, softcap=20.0),
]


def f32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


# ------------------------------------------------ no silent CPU fallback
def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        gemm_cuda(x, x)
    q = torch.zeros((1, 1, 2, 16))
    with pytest.raises(ValueError):
        decode_attention_cuda(q, q, q, torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)


# --------------------------------------------------- the kernels on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernels_match_plain_versions(cuda_device, rng, dt):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(device=cuda_device, dtype=tdt)

    atol = 1e-3 if dt == "f32" else 5e-2
    for m, k, n in [(1, 64, 1), (4, 300, 130), (33, 257, 65), (100, 128, 256)]:
        a, b = t(m, k), t(k, n)
        np.testing.assert_allclose(f32(gemm_cuda(a, b)),
                                   f32(gemm_ref(a, b)), atol=atol * k ** 0.5,
                                   rtol=1e-2)
    q, k, v = t(2, 8, 129, 64), t(2, 2, 129, 64), t(2, 2, 129, 64)
    for kw in FLASH_VARIANTS:
        np.testing.assert_allclose(f32(flash_attention_cuda(q, k, v, **kw)),
                                   f32(attention_ref(q, k, v, **kw)),
                                   atol=atol * 10, rtol=1e-2)
    qd, kd, vd = t(2, 2, 4, 64), t(2, 2, 200, 64), t(2, 2, 200, 64)
    ln = torch.tensor([37, 190], dtype=torch.int32, device=cuda_device)
    for window in (None, 50, 16):
        np.testing.assert_allclose(
            f32(decode_attention_cuda(qd, kd, vd, ln, window=window)),
            f32(decode_attention_ref(qd, kd, vd, ln, window=window)),
            atol=atol * 10, rtol=1e-2)
