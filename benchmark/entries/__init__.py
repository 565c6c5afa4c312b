"""What one request of each traffic kind is.

A traffic file names its ``entry``; ``load(name)`` finds the class in
benchmark/entries/<name>.py. The harness (benchmark/run.py,
benchmark/readings.py) knows nothing of the system beyond what ``Entry``
defines: an entry makes an input set from a generator, prepares the
program for it, runs one request (ending in a device synchronisation),
turns a finished request's outputs into answers, judges them against the
plain reference, and computes the control's numbers in the program's
place. A new kind of request is a new file here and nothing else.

The program is imported by these modules only: the reference
(benchmark/reference/) imports none of it.
"""

from __future__ import annotations

import importlib

import numpy as np


class Entry:
    """One traffic kind. ``cfg_file``: the configuration file; ``request``:
    the traffic file's ``request`` group; ``device``: where the program
    runs; ``workdir``: a directory inside the checkout for files a request
    reads."""

    def __init__(self, cfg_file: dict, request: dict, device, workdir):
        self.cfg_file, self.req, self.device = cfg_file, request, device
        self.workdir = workdir

    def make_set(self, rng: np.random.Generator) -> dict:
        """An input set drawn from ``rng``: the data both the program and
        the reference receive, and the request's own draws."""
        raise NotImplementedError

    def add_set(self, inputs: dict) -> None:
        """Prepare the program for the input set ``inputs`` (set-up)."""
        raise NotImplementedError

    def request(self, k: int):
        """One request on input set k; returns its outputs."""
        raise NotImplementedError

    def stage_seconds(self, out):
        """The program's own stage walls of a finished request, or None."""
        return None

    def filter_calls(self) -> list:
        """(kernel, steps, lanes) of each filter call one request needs."""
        return []

    def answers(self, out, k: int) -> dict:
        """What ``check`` judges of ``out``, a finished request on input set
        k, detached from the program's state."""
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's state (before the reference runs)."""
        raise NotImplementedError

    def check(self, ans: dict, k: int, log=None) -> dict:
        """The compared numbers (name -> value, 0 when equal to the
        reference) of the answers of a request on input set k."""
        raise NotImplementedError

    def control(self, inputs: dict, log=None) -> dict:
        """The compared numbers with the reference computed one precision
        below the configuration's in the program's place, on the input set
        ``inputs``."""
        raise NotImplementedError


def load(name: str):
    """The entry class of benchmark/entries/<name>.py."""
    return importlib.import_module(f"{__name__}.{name}").Entry
