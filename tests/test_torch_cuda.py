"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Every test here carries the ``cuda`` marker and skips where there is
no card. The file imports neither JAX nor the JAX package, so on the
card's machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: normalized inf-norm error max|k - p| / max|p| <= 1e-4 in float32
(the same f32 arithmetic summed in another order, TF32 off) and <= 2e-2 in
bfloat16 (the bf16 bound of benchmarks/tpu_kernel_parity.json).
"""

import numpy as np
import pytest
import torch

from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

pytestmark = pytest.mark.cuda

N, K = 19, 2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, *, t, b, d, h, num_supports, shared, stream, seed=0):
    rng = np.random.RandomState(seed)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(
        num_supports, 1 if shared else b, N, N)) / N).astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
    hidden = (f(m, h, 2 * h), f(m, h, h), f(2 * h), f(h), f(b, N, h))
    xin = (f(t, b, N, d, scale=1.0).to(stream), a_ops, f(m * d, 2 * h),
           f(m * d, h), *hidden)
    hoisted = (f(t, b, N, 3 * h, scale=0.5).to(stream), a_ops, *hidden)
    return xin, hoisted


def _err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("t,b,d,h", [(5, 4, 12, 16), (60, 37, 100, 64)])
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain(dev, t, b, d, h, num_supports, shared, bf16):
    stream = torch.bfloat16 if bf16 else torch.float32
    xin, hoisted = _inputs(dev, t=t, b=b, d=d, h=h,
                           num_supports=num_supports, shared=shared,
                           stream=stream)
    tol = 2e-2 if bf16 else 1e-4
    for kern, plain, args in (
            (cr.dcgru_recurrence_xin_fwd, cr.dcgru_recurrence_xin_fwd_plain,
             xin),
            (cr.dcgru_recurrence_fwd, cr.dcgru_recurrence_fwd_plain,
             hoisted)):
        before = kern.launches
        got = kern(*args, residuals=True)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g, w in zip(got, plain(*args, residuals=True)):
            assert g.dtype == stream and g.shape == w.shape
            assert _err(g, w) <= tol


@pytest.mark.parametrize("activation", ["relu", "linear"])
def test_kernel_activations(dev, activation):
    xin, hoisted = _inputs(dev, t=5, b=3, d=12, h=16, num_supports=2,
                           shared=False, stream=torch.float32)
    for kern, plain, args in (
            (cr.dcgru_recurrence_xin_fwd, cr.dcgru_recurrence_xin_fwd_plain,
             xin),
            (cr.dcgru_recurrence_fwd, cr.dcgru_recurrence_fwd_plain,
             hoisted)):
        assert _err(kern(*args, activation)[0],
                    plain(*args, activation)[0]) <= 1e-4


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    xin, hoisted = _inputs(dev, t=5, b=3, d=12, h=16, num_supports=1,
                           shared=False, stream=torch.float32)
    x = xin[0]
    with pytest.raises(ValueError, match="contiguous"):
        cr.dcgru_recurrence_xin_fwd(x.transpose(0, 1).contiguous()
                                    .transpose(0, 1), *xin[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cr.dcgru_recurrence_xin_fwd(x.half(), *xin[1:])
    with pytest.raises(TypeError, match="must be float32"):
        cr.dcgru_recurrence_fwd(hoisted[0], hoisted[1].double(),
                                *hoisted[2:])
    with pytest.raises(ValueError, match="multiple of 4"):
        cr.dcgru_recurrence_xin_fwd(x[..., :10].contiguous(), xin[1],
                                    xin[2][:30].contiguous(),
                                    xin[3][:30].contiguous(), *xin[4:])
