"""Multi-process (multi-host) mesh runs and their dry-run harness.

Counterpart of epidemicmodeling_tpu/parallel/multihost.py. The reference
is one serial process; beyond one host its embarrassingly parallel
region x epsilon loop nest maps onto a mesh that SPANS processes:

    dp (regions)  across processes
    ep (ensemble) within one process

Mechanics: every process calls ``init_distributed`` against a shared
rendezvous, builds the same global mesh (``make_multihost_mesh``: its own
slots, the other processes' slots by their owner), and runs the same
pipeline on identical host data. Each EKS kernel call runs the blocks of
the lane axis that this process's slots own and joins every block with an
all_gather on the mesh's group (ops/cuda/shard.py); the rest of the
pipeline runs replicated on each process's lead slot, so every process ends
with the full results. The pipeline itself has no multi-process special
case.

The dry run checks this on one machine: N OS processes x M slots each (CPU
slots, or slots that share one card), Gloo over localhost standing in for
the network, and a J0 / a2 parity pin against the same mesh in one process.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..utils.device import resolve_device
from .mesh import Mesh, sharded_train_prescribe_step

# the slots of this process, recorded by init_distributed (the counterpart
# of jax.local_devices() after jax.distributed.initialize)
_LOCAL_DEVICES: list = []


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _store(coordinator: str, num_processes: int, process_id: int,
           timeout: datetime.timedelta):
    """The rendezvous store: ``file://<path>`` (one machine), else a TCP
    store at ``[tcp://]host:port`` served by process 0."""
    import torch.distributed as dist

    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], num_processes)
    host, port = coordinator.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes, process_id == 0,
                         timeout)


def _slot_key(dev: torch.device) -> str:
    """What identifies a slot's device across processes: a card by its host
    and UUID; a CPU slot is never a card."""
    if dev.type != "cuda":
        return "cpu"
    uuid = torch.cuda.get_device_properties(dev).uuid
    return f"{socket.gethostname()}/{uuid}"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_devices, timeout: int = 300) -> str:
    """Join the process group with ``local_devices`` as this process's mesh
    slots (a list of devices, a device may repeat; an int n means n CPU
    slots). Returns the backend.

    The processes first publish their slots' cards on the rendezvous store;
    the backend is then "nccl" when every slot is a card and no card is
    held by two processes, else "gloo" (NCCL refuses two ranks on one
    card). ``timeout`` (seconds) bounds the rendezvous and every
    collective, so a lost peer fails the run instead of hanging it."""
    import torch.distributed as dist

    if isinstance(local_devices, int):
        local_devices = ["cpu"] * local_devices
    local = [resolve_device(d) for d in local_devices]
    td = datetime.timedelta(seconds=timeout)
    store = _store(coordinator, num_processes, process_id, td)
    store.set(f"epi_slots/{process_id}",
              json.dumps([_slot_key(d) for d in local]))
    names = [f"epi_slots/{r}" for r in range(num_processes)]
    store.wait(names, td)
    keys = [set(json.loads(store.get(n))) for n in names]
    cards = [k for k in keys if "cpu" not in k]
    shared = any(a & b for i, a in enumerate(keys) for b in keys[i + 1:])
    backend = ("nccl" if len(cards) == num_processes and not shared
               else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=td)
    _LOCAL_DEVICES[:] = local
    return backend


def make_multihost_mesh(ep: int | None = None, n_total: int | None = None,
                        axis_names=("dp", "ep")) -> Mesh:
    """Global mesh with dp spanning processes and ep within one.

    The slots are ordered process-major (each process's own, as
    init_distributed recorded them, after those of lower ranks), so
    reshaping to (n // ep, ep) with ep dividing the slots of a process puts
    a process's slots on the ep axis and spreads dp across processes. Pass
    ``ep`` explicitly to pin the factorization (the dry run's
    single-process reference does, so both runs use the same mesh shape).
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh: call init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    gathered = [None] * world
    dist.all_gather_object(gathered, [str(d) for d in _LOCAL_DEVICES])
    devs = [d for g in gathered for d in g]
    owners = [r for r, g in enumerate(gathered) for _ in g]
    if n_total is not None:
        devs, owners = devs[:n_total], owners[:n_total]
    n, local = len(devs), len(_LOCAL_DEVICES)
    if ep is None:
        ep = max(k for k in range(1, local + 1)
                 if n % k == 0 and local % k == 0)
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devs]
    return Mesh(grid.reshape(n // ep, ep), axis_names,
                process_index=np.reshape(owners, (n // ep, ep)),
                group=dist.group.WORLD, rank=rank)


def _launches() -> dict:
    from ..ops.cuda import ekf3_kernel, ekf6_kernel
    return {"ekf3": ekf3_kernel.launches, "ekf6": ekf6_kernel.launches}


def _worker(out_path: str, coordinator: str, num_processes: int,
            process_id: int, local_devices: int, R: int, E: int,
            T_hist: int, horizon: int, backend: str, device: str,
            timeout: int) -> None:
    import torch.distributed as dist

    pg = init_distributed(coordinator, num_processes, process_id,
                          [device] * local_devices, timeout=timeout)
    try:
        mesh = make_multihost_mesh(ep=local_devices)
        out = sharded_train_prescribe_step(mesh, R=R, E=E, T_hist=T_hist,
                                           horizon=horizon, backend=backend)
        J0 = out["J0"].cpu().numpy()
        a2 = out["a2"].cpu().numpy()
        # every process ends with the full (E, R) surface (the kernel
        # outputs are gathered, the glue is replicated): the copies agree
        copies = [None] * num_processes
        dist.all_gather_object(copies, (J0, a2))
        if not all(np.array_equal(c[0], J0) and np.array_equal(c[1], a2)
                   for c in copies):
            raise RuntimeError("the processes' results differ")
        print(f"[worker {process_id}] backend={pg} mesh={mesh.shape} "
              f"local={len(mesh.local_slots())}/{mesh.size} J0 {J0.shape} "
              f"finite={bool(np.isfinite(J0).all())} "
              f"launches={_launches()}", flush=True)
        if process_id == 0:
            np.savez(out_path, J0=J0, a2=a2)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _reference(out_path: str, n_devices: int, ep: int, R: int, E: int,
               T_hist: int, horizon: int, backend: str, device: str) -> None:
    """The same step in ONE process on n_devices slots of ``device``: the
    parity baseline, with the workers' mesh shape."""
    grid = np.empty(n_devices, dtype=object)
    grid[:] = [resolve_device(device)] * n_devices
    mesh = Mesh(grid.reshape(n_devices // ep, ep))
    out = sharded_train_prescribe_step(mesh, R=R, E=E, T_hist=T_hist,
                                       horizon=horizon, backend=backend)
    print(f"[reference] mesh={mesh.shape} launches={_launches()}",
          flush=True)
    np.savez(out_path, J0=out["J0"].cpu().numpy(),
             a2=out["a2"].cpu().numpy())


def run_multihost_dryrun(n_devices: int = 8, n_processes: int = 2,
                         R: int = 4, E: int = 4, T_hist: int = 48,
                         horizon: int = 16, backend: str = "lanes",
                         timeout: int = 300, verbose: bool = True,
                         summary: bool = False, device=None) -> dict:
    """Spawn a single-process reference, then ``n_processes`` workers
    (n_devices slots split evenly between them, each slot on ``device``:
    the CUDA card by default, or "cpu"), joined by a file rendezvous in a
    temporary directory, and pin J0 / a2 parity (< 1e-9).

    Every child runs with ``timeout`` seconds: its rendezvous and
    collectives, and its wall (it is killed past it). Returns {"J0": ...,
    "max_abs_diff": ..., "max_abs_diff_a2": ...}; raises on any child
    failure or parity violation. verbose=True prints the child logs;
    summary=True just the final OK line."""
    if n_devices % n_processes:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"{n_processes} processes")
    local = n_devices // n_processes
    dev = str(resolve_device(device))
    root = _repo_root()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [root, env.get("PYTHONPATH", "")] if p)
    module = "epidemicmodeling_torch.parallel.multihost"

    with tempfile.TemporaryDirectory() as td:
        wout = os.path.join(td, "worker.npz")
        rout = os.path.join(td, "ref.npz")
        common = ["--R", str(R), "--E", str(E), "--T-hist", str(T_hist),
                  "--horizon", str(horizon), "--backend", backend,
                  "--device", dev, "--local-devices", str(local),
                  "--timeout", str(timeout)]
        logs, fail = [], []

        def spawn(*args):
            return subprocess.Popen(
                [sys.executable, "-m", module, *args, *common], env=env,
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)

        def drain(name, p):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                fail.append(f"{name}: timeout after {timeout}s")
            logs.append(f"--- {name} ---\n{out}")
            if p.returncode != 0:
                fail.append(f"{name}: exit {p.returncode}")

        # the reference first, alone: the workers then share the machine
        # only with each other
        drain("reference", spawn("reference", "--out", rout,
                                 "--n-devices", str(n_devices)))
        procs = []
        if not fail:
            rendezvous = "file://" + os.path.join(td, "rendezvous")
            try:
                for pid in range(n_processes):
                    procs.append(spawn(
                        "worker", "--out", wout, "--coordinator", rendezvous,
                        "--num-processes", str(n_processes),
                        "--process-id", str(pid)))
            finally:
                for i, p in enumerate(procs):
                    drain(f"worker{i}", p)
        if verbose:
            print("\n".join(logs), flush=True)
        if fail:
            raise RuntimeError("multihost dryrun failed: " + "; ".join(fail)
                               + "\n" + "\n".join(logs))

        w = np.load(wout)
        r = np.load(rout)
        dj = float(np.max(np.abs(w["J0"] - r["J0"])))
        da = float(np.max(np.abs(w["a2"] - r["a2"])))
        if not (np.isfinite(w["J0"]).all() and dj < 1e-9 and da < 1e-9):
            raise RuntimeError(
                f"multihost parity violation: max|dJ0|={dj:.3e} "
                f"max|da2|={da:.3e}")
        if verbose or summary:
            print(f"multihost dryrun OK [{backend}]: {n_processes} procs x "
                  f"{local} slots on {dev}, J0 {w['J0'].shape}, "
                  f"max|dJ0| vs single-process = {dj:.2e}, max|da2| = "
                  f"{da:.2e}", flush=True)
        return {"J0": w["J0"], "max_abs_diff": dj, "max_abs_diff_a2": da,
                "logs": logs}


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="multihost")
    ap.add_argument("role", choices=["worker", "reference"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--coordinator",
                    help="file://<path>, or [tcp://]host:port served by "
                         "process 0")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--n-devices", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the device of every slot (default: the CUDA card)")
    ap.add_argument("--R", type=int, default=4)
    ap.add_argument("--E", type=int, default=4)
    ap.add_argument("--T-hist", type=int, default=48)
    ap.add_argument("--horizon", type=int, default=16)
    ap.add_argument("--backend", default="lanes")
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for the rendezvous and each collective")
    a = ap.parse_args(argv)
    if resolve_device(a.device).type == "cpu":
        # one thread: the same reduction order in every process
        torch.set_num_threads(1)
    if a.role == "worker":
        _worker(a.out, a.coordinator, a.num_processes, a.process_id,
                a.local_devices, a.R, a.E, a.T_hist, a.horizon, a.backend,
                a.device, a.timeout)
    else:
        _reference(a.out, a.n_devices, a.local_devices, a.R, a.E, a.T_hist,
                   a.horizon, a.backend, a.device)


if __name__ == "__main__":
    _main()
