"""A module fixture's result that several test files share, computed once
a test run: in one process a memo, and across the workers of a parallel
run (pytest-xdist) a pickle in the run's base temporary directory, made
under a file lock by the first worker that asks for it (zlib at level 1:
a map's untouched voxels are mostly one value, and a GB of them writes
as tens of MB in about 2 s)."""

from __future__ import annotations

import os
import pickle
import zlib

from filelock import FileLock

_MEMO: dict = {}


def shared(name: str, make, tmp_path_factory):
    """make()'s result, made once a run and shared by every caller that
    passes `name`; it must pickle. A worker of a parallel run keeps no
    copy: the caller's fixture holds it while its module runs."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        if name not in _MEMO:
            _MEMO[name] = make()
        return _MEMO[name]
    # the run's base temporary directory, shared by its workers
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(f"{path}.lock"):
        if path.exists():
            with open(path, "rb") as fh:
                return pickle.loads(zlib.decompress(fh.read()))
        out = make()
        with open(path, "wb") as fh:
            fh.write(zlib.compress(pickle.dumps(out), 1))
    return out
