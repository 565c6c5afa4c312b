"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the marker
``cuda``); this file imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q

B = 300 lanes is not a multiple of the 128-thread block, so the ragged
edge the kernels mask is exercised. Tolerances are those of the CPU tests
(tests/test_ekf6_kernel.py:83-86,188-190): both sides run float32 in a
different operation order, and roundoff compounds on the costates.
"""

import numpy as np
import pytest
import torch

from epidemicmodeling_torch.ops.cuda import ekf3_kernel, ekf6_kernel
from epidemicmodeling_torch.ops.cuda.ekf3_kernel import ekf3, ekf3_plain
from epidemicmodeling_torch.ops.cuda.ekf6_kernel import ekf6, ekf6_plain

from tests._torch_helpers import (make_inputs, masked_err, packed_args,
                                  scaled_err)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf3_kernel_matches_plain(cuda, obs_type, beta):
    args = packed_args(3, make_inputs(3, B=300, T=120, T_hist=90, seed=3,
                                      obs_type=obs_type,
                                      dtype=np.float32), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    before = ekf3_kernel.launches
    ssm, sp, sm = ekf3(*args, **kw)
    torch.cuda.synchronize()
    assert ekf3_kernel.launches == before + 1
    r_ssm, r_sp, r_sm = ekf3_plain(*args, **kw)
    assert ekf3_kernel.launches == before + 1
    assert all(bool(torch.isfinite(o).all()) for o in (ssm, sp, sm))
    assert scaled_err(sp, r_sp) < 1e-4
    assert scaled_err(sm, r_sm) < 1e-4
    assert scaled_err(ssm, r_ssm) < 1e-3


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf6_kernel_matches_plain(cuda, obs_type, beta):
    T_hist = 64
    args = packed_args(6, make_inputs(6, B=300, T=96, T_hist=T_hist, seed=4,
                                      obs_type=obs_type,
                                      dtype=np.float32), cuda)
    kw = dict(gamma_discount=0.995, obs_type=obs_type, beta=beta,
              inv_monitor_len=21)
    before = ekf6_kernel.launches
    ssm, usm, sp = ekf6(*args, **kw)
    torch.cuda.synchronize()
    assert ekf6_kernel.launches == before + 1
    r_ssm, r_usm, r_sp = ekf6_plain(*args, **kw)
    assert bool(torch.isfinite(usm).all())
    assert bool(torch.isfinite(ssm[:, :3]).all())
    err, mismatch = masked_err(sp, r_sp)
    assert err < 1e-3 and mismatch <= 1e-3
    err, mismatch = masked_err(ssm, r_ssm)
    assert err < 1e-2 and mismatch <= 1e-3
    diff = (usm[T_hist:-1] != r_usm[T_hist:-1]).double().mean()
    assert float(diff) <= 5e-3
    assert bool((usm[-1] == 0).all())


def test_kernels_refuse_what_they_cannot_take(cuda):
    args = packed_args(3, make_inputs(3, B=40, T=20, T_hist=15, seed=1,
                                      dtype=np.float32), cuda)
    with pytest.raises(ValueError, match="float32"):
        ekf3(*(a.double() for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        ekf3(args[0].transpose(0, 2).contiguous().transpose(0, 2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ekf3(args[0][:, :, :30].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        ekf3(args[0], args[1].cpu(), *args[2:])
    args6 = packed_args(6, make_inputs(6, B=40, T=20, T_hist=15, seed=1,
                                       dtype=np.float32), cuda)
    with pytest.raises(ValueError, match="inv_monitor_len"):
        ekf6(*args6, beta=0.9, inv_monitor_len=0)

