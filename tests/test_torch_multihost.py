"""The port's multi-process dry run: two OS processes x two CPU slots each,
joined by Gloo through a file rendezvous in a temporary directory, against
the same mesh in one process (tests/test_multihost.py and
test_multihost_pallas.py's counterpart). J0 and the trained a2 must agree
to < 1e-9 (run_multihost_dryrun raises otherwise); the children import no
JAX. Every child, its rendezvous and its collectives are bounded by the
timeout, so a hang fails the test instead of the whole run."""

import numpy as np
import pytest

from epidemicmodeling_torch.parallel.multihost import run_multihost_dryrun


@pytest.mark.parametrize("backend", ["lanes", "pallas"])
def test_multihost_dryrun_matches_single_process(backend):
    out = run_multihost_dryrun(n_devices=4, n_processes=2, R=4, E=4,
                               T_hist=32, horizon=8, backend=backend,
                               timeout=240, verbose=False, device="cpu")
    assert out["J0"].shape == (4, 4)
    assert np.isfinite(out["J0"]).all()
    assert out["max_abs_diff"] < 1e-9 and out["max_abs_diff_a2"] < 1e-9
    assert any("backend=gloo" in log for log in out["logs"])
