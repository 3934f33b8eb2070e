"""Imported by every ``tests/test_torch_*.py``: the port's CPU tests run
torch, and the BLAS and OpenMP pools that numpy and torch load, on one
thread in each test process.

The tier-1 run puts six pytest workers on the machine's cores, and the
port's tests spawn gloo ranks and JAX reference processes beside them;
each worker's own intra-op pools would then size themselves to every
core, and their spinning threads oversubscribe the machine.  Every test
compares runs that this module sets alike (two port runs, or a port run
against a JAX reference at a stated tolerance), so the thread count moves
no result a test reads."""
import torch

torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:          # then only torch's own pool is held to one
    pass
else:
    threadpool_limits(limits=1)
