"""Checkpoint files of trained per-region parameters, and carry-over.

Counterpart of epidemicmodeling_tpu/pipelines/checkpoint.py. The reference
persists a MATLAB cell table {Country, Region, N_population, reg_coef_b,
reg_coef_a, reg_coef_b2, reg_coef_a2} in a .mat file
(Tools/TrainPredictPrescribeNPI.m:910-913, loaded by
testScripts/testPrescribeXPRIZE01.m:62). The same parameters are stored
as a portable .npz with a JSON names manifest, or in the reference's .mat
schema (scipy.io); a file written by either package loads in the other.
The JAX package's directory checkpoint (orbax) has its counterpart in
``save_trained_params_dcp`` / ``load_trained_params_dcp``
(torch.distributed.checkpoint, the same ``<dir>.names.json`` sidecar); the
two on-disk formats differ, so each package reads only its own.

``trained_params_from_numpy`` / ``region_init_from_numpy`` turn the JAX
package's TrainedRegionParams / RegionInit (or any mapping of their fields)
into the port's, so one stage of each package can run on the other's inputs.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings

import numpy as np
import torch

from ..utils.math import host_array
from .core import RegionInit, TrainedRegionParams, to_tensor

_ARRAYS = ("a1", "b1", "a2", "b2")


def _fields(d) -> dict:
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def trained_params_from_numpy(d, dtype=None,
                              device=None) -> TrainedRegionParams:
    """d: names, population, a1, b1, a2, b2 (a TrainedRegionParams of
    either package, or a mapping of arrays). dtype None keeps float64."""
    d = _fields(d)
    t = lambda k: to_tensor(d[k], dtype, device)
    return TrainedRegionParams(
        names=tuple(str(n) for n in d["names"]),
        population=np.asarray(d["population"], float),
        a1=t("a1"), b1=t("b1"), a2=t("a2"), b2=t("b2"))


def region_init_from_numpy(d, dtype=None, device=None) -> RegionInit:
    """d: I0, s_init, Ps_init, Q, s_noise_std, i_noise_std (a RegionInit of
    either package, or a mapping of arrays). dtype None keeps float64."""
    d = _fields(d)
    return RegionInit(*(to_tensor(d[k], dtype, device)
                        for k in RegionInit._fields))


def _with_suffix(path, suffix: str) -> str:
    path = str(path)
    return path if path.endswith(suffix) else path + suffix


def save_trained_params(path, trained: TrainedRegionParams) -> None:
    """Save per-region trained coefficients to ``path`` (.npz appended if
    missing): the arrays in their own dtype, the names as a JSON list."""
    np.savez(_with_suffix(path, ".npz"),
             names=json.dumps(list(trained.names)),
             population=host_array(trained.population),
             **{k: host_array(getattr(trained, k)) for k in _ARRAYS})


def load_trained_params(path) -> TrainedRegionParams:
    """Load a save_trained_params .npz (either package's): CPU tensors in
    the stored dtype (the testPrescribeXPRIZE01.m:62 flow, prescribe without
    retraining)."""
    z = np.load(_with_suffix(path, ".npz"), allow_pickle=False)
    return trained_params_from_numpy(dict(
        names=json.loads(str(z["names"])), population=z["population"],
        **{k: z[k] for k in _ARRAYS}))


@contextlib.contextmanager
def _one_process():
    """Silence dcp's notice that, with no process group, it saves or loads
    in one process: that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def save_trained_params_dcp(directory, trained: TrainedRegionParams) -> str:
    """Directory checkpoint of the trained parameters through
    torch.distributed.checkpoint (one process, no process group): the state
    dict {population, a1, b1, a2, b2} of CPU tensors in their own dtype,
    the names in the ``<dir>.names.json`` sidecar (the orbax pair's layout,
    epidemicmodeling_tpu/pipelines/checkpoint.py:51). Returns the absolute
    directory."""
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(str(directory))
    state = {k: torch.from_numpy(np.array(host_array(getattr(trained, k))))
             for k in ("population",) + _ARRAYS}
    with _one_process():
        dcp.save(state, checkpoint_id=directory, no_dist=True)
    with open(directory + ".names.json", "w") as f:
        json.dump(list(trained.names), f)
    return directory


def load_trained_params_dcp(directory) -> TrainedRegionParams:
    """Restore a save_trained_params_dcp directory: CPU tensors (population a
    NumPy array), float64 as the other loaders give them."""
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(str(directory))
    meta = dcp.FileSystemReader(directory).read_metadata()
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in meta.state_dict_metadata.items()}
    with _one_process():
        dcp.load(state, checkpoint_id=directory, no_dist=True)
    with open(directory + ".names.json") as f:
        names = json.load(f)
    return trained_params_from_numpy(dict(
        names=names, **{k: v.numpy() for k, v in state.items()}))


def load_trained_params_mat(path) -> TrainedRegionParams:
    """Import the reference's own trained-parameter checkpoint: a MATLAB
    cell table {CountryName, RegionName, N_population, coef0, coef,
    coef0_2, coef_2} with a header row (Tools/TrainPredictPrescribeNPI.m:
    91,910-913). Coefficient vectors are cut or zero-padded to 12 NPIs.
    Returns float64 CPU tensors."""
    import scipy.io as sio

    tbl = sio.loadmat(str(path))["TrainedModelParams"]

    def scalar(cell):
        v = np.squeeze(cell)
        return float(v) if v.size else 0.0

    def vec12(cell):
        v = np.asarray(cell, float).ravel()
        out = np.zeros(12)
        out[:min(12, v.size)] = v[:12]
        return out

    def name(cell):
        v = np.squeeze(cell)
        return str(v) if v.size else ""

    rows = [tbl[r] for r in range(1, tbl.shape[0])]   # row 0: the header
    return trained_params_from_numpy(dict(
        names=[f"{name(row[0])} {name(row[1])}" for row in rows],
        population=[scalar(row[2]) for row in rows],
        b1=np.array([scalar(row[3]) for row in rows]),
        a1=np.array([vec12(row[4]) for row in rows]).reshape(-1, 12),
        b2=np.array([scalar(row[5]) for row in rows]),
        a2=np.array([vec12(row[6]) for row in rows]).reshape(-1, 12)))


def save_trained_params_mat(path, trained: TrainedRegionParams) -> str:
    """Export to the reference's .mat schema (the TrainedModelParams cell
    table of TrainPredictPrescribeNPI.m:910-913), the inverse of
    load_trained_params_mat. Returns the path written (.mat appended if
    missing)."""
    import scipy.io as sio
    from ..data.xprize_io import _split_geo

    path = _with_suffix(path, ".mat")
    R = len(trained.names)
    tbl = np.empty((R + 1, 7), dtype=object)
    tbl[0] = ["CountryName", "RegionName", "N_population",
              "coef0", "coef", "coef0_2", "coef_2"]
    pop = host_array(trained.population)
    a1, b1, a2, b2 = (host_array(getattr(trained, k)) for k in _ARRAYS)
    for r, name in enumerate(trained.names):
        tbl[r + 1, 0], tbl[r + 1, 1] = _split_geo(name)
        tbl[r + 1, 2] = float(pop[r])
        tbl[r + 1, 3] = float(b1[r])
        tbl[r + 1, 4] = a1[r].reshape(-1, 1)
        tbl[r + 1, 5] = float(b2[r])
        tbl[r + 1, 6] = a2[r].reshape(-1, 1)
    sio.savemat(path, {"TrainedModelParams": tbl})
    return path


def save_checkpoint(path, trained: TrainedRegionParams) -> None:
    """save_trained_params_mat for a .mat path, else save_trained_params."""
    save = (save_trained_params_mat if str(path).endswith(".mat")
            else save_trained_params)
    save(path, trained)


def load_checkpoint(path) -> TrainedRegionParams:
    """load_trained_params_mat for a .mat path, else load_trained_params."""
    load = (load_trained_params_mat if str(path).endswith(".mat")
            else load_trained_params)
    return load(path)
