"""The process settings of the port's tests, applied when a test module of
the port imports this one (every ``tests/test_torch_*.py`` does, taking
the fixture ``process_settings``; a pytest worker collects every test
module, so a whole run takes them):

* one intra-op thread for torch on the CPU, in the test processes and,
  through ``OMP_NUM_THREADS``, in the processes they start: the tests run
  several workers at once, each with its own reference subprocesses and
  rank processes, and torch's default of a thread per core makes them
  spin against each other for the same cores (the rank processes were
  started with one thread already);
* compiled bytecode shared by every process of the run
  (``PYTHONPYCACHEPREFIX``): where the environment says not to write
  bytecode (``PYTHONDONTWRITEBYTECODE``), every process the tests start
  would compile the modules of JAX, the reference and the port again, a
  few seconds each.  The directory is the test process's own, under the
  temporary directory, named after pytest-xdist's run id and worker (the
  process id outside xdist), shared with the processes it starts; the
  test process removes it at the end of its session (and, failing that,
  when it exits), so no worker removes a cache another still reads.

Neither changes a result: each process's computation is the same code on
the same inputs."""
import atexit
import os
import shutil
import sys
import tempfile

import pytest
import torch

torch.set_num_threads(1)
os.environ["OMP_NUM_THREADS"] = "1"

_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID")
_OWN = (f"{_RUN}-{os.environ.get('PYTEST_XDIST_WORKER', 'main')}" if _RUN
        else f"pid{os.getpid()}")
PYCACHE = os.path.join(tempfile.gettempdir(), f"repro-pycache-{_OWN}")
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
sys.dont_write_bytecode = False
sys.pycache_prefix = PYCACHE
atexit.register(shutil.rmtree, PYCACHE, ignore_errors=True)


@pytest.fixture(scope="session", autouse=True)
def process_settings():
    """Remove the run's bytecode at the end of the session."""
    yield
    shutil.rmtree(PYCACHE, ignore_errors=True)
