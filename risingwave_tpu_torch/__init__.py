"""risingwave_tpu_torch: the PyTorch/CUDA port of ``risingwave_tpu``.

The same streaming engine, with device state held as torch tensors and
every device kernel written by hand in CUDA C++ for Hopper (``sm_90a``).
The JAX package beside it is the reference: each module here mirrors a
module there, and the tests run both on the same inputs.

Layering (mirrors the reference package):

    common/      types, chunks, epochs, host and plain-torch hashing
    ops/         device state and kernel wrappers (hash table, grouped agg)
    csrc/        the CUDA C++ kernels, built with nvcc and bound via ctypes
    state/       state-store interface + relational StateTable (epoch MVCC)
    stream/      executors, actors, exchange channels
    meta/        the barrier/checkpoint loop
    connectors/  the Nexmark bid generator
    expr/        the expressions q7 needs (column refs, literals, tumble)
    models/      hand-built pipelines (Nexmark q7-core)
    utils/       device placement, transfers, launch counters

Host code stays numpy, as in the reference: chunks, expressions, state
tables and the generator run on the host; only device state and kernels
are torch tensors. Entry points take ``device=None``, meaning ``"cuda"``;
pass ``device="cpu"`` to run every kernel's plain PyTorch version.
"""
