"""The directory checkpoint of trained parameters through
torch.distributed.checkpoint (pipelines/checkpoint.save_trained_params_dcp /
load_trained_params_dcp), the counterpart of the JAX package's orbax pair:
random trained tables (tests/test_checkpoint_fuzz.py's recipe) round-trip
bit for bit, and what the dcp pair restores equals what the orbax pair
restores from the same parameters. The two on-disk formats differ."""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

from epidemicmodeling_tpu.pipelines.checkpoint import (
    load_trained_params_orbax, save_trained_params_orbax)
from epidemicmodeling_torch.pipelines import (load_trained_params_dcp,
                                              save_trained_params_dcp,
                                              trained_params_from_numpy)
from tests.test_checkpoint_fuzz import _assert_trained_equal, _random_trained


@pytest.mark.parametrize("seed", range(4))
def test_dcp_roundtrip_fuzz(seed):
    trained = _random_trained(np.random.default_rng(10700 + seed))
    with tempfile.TemporaryDirectory() as td:
        d = save_trained_params_dcp(Path(td) / "dcp_ck", trained)
        assert d == str(Path(td, "dcp_ck").resolve())
        assert json.loads(Path(d + ".names.json").read_text()) == \
            list(trained.names)
        got = load_trained_params_dcp(d)
    _assert_trained_equal(got, trained)
    assert got.a1.device.type == "cpu"


def test_dcp_saves_the_port_params_too():
    """A TrainedRegionParams of the port (tensors) saves as well."""
    trained = trained_params_from_numpy(
        _random_trained(np.random.default_rng(5)), device="cpu")
    with tempfile.TemporaryDirectory() as td:
        got = load_trained_params_dcp(
            save_trained_params_dcp(Path(td) / "ck", trained))
    _assert_trained_equal(got, trained)


@pytest.mark.parametrize("seed", range(2))
def test_dcp_restores_what_orbax_restores(seed):
    trained = _random_trained(np.random.default_rng(20700 + seed))
    with tempfile.TemporaryDirectory() as td:
        mine = load_trained_params_dcp(
            save_trained_params_dcp(Path(td) / "dcp", trained))
        theirs = load_trained_params_orbax(
            save_trained_params_orbax(Path(td) / "orbax", trained))
    _assert_trained_equal(mine, theirs)
