"""carca_tpu — a CARCA-style sequential scoring engine in JAX.

A JAX/XLA/Pallas framework with the capabilities of the PyTorch
reference ``r-papso/carca-replication`` (context- and attribute-aware
sequential recommendation via cross-attention, RecSys'22), built for an
accelerator (an NVIDIA H100 GPU):

* pure-functional model core (params are pytrees; ``init``/``apply`` pairs)
* device-resident item catalog: attribute vectors live in device memory
  and are gathered on device from int32 ids (the reference ships dense
  ``[B, L, n_attrs]`` float tensors from host every step)
* a fused Pallas (Triton-route) kernel for the full-catalog retrieval
  scan; attention is plain jnp that XLA fuses
* ``jax.sharding.Mesh('data','model')`` parallelism: batch-sharded data
  parallel training, row-sharded embedding/attribute tables with XLA
  collectives, sharded full-catalog retrieval top-k
* full train-state checkpoint/resume (params + optimizer + PRNG + step)

Reference parity contract: see SURVEY.md at the repo root. Reference file
citations in docstrings (``src/carca.py:...`` etc.) point into the read-only
reference checkout and document the behavior being reproduced, not code
being copied.
"""

import os as _os

import jax as _jax

# PRNG implementation override (e.g. CARCA_PRNG_IMPL=rbg): the dropout
# sites draw tens of millions of bits per step, so the generator can show
# in the step time. Default: JAX's own (threefry2x32).
_impl = _os.environ.get("CARCA_PRNG_IMPL")
if _impl:
    _jax.config.update("jax_default_prng_impl", _impl)

from carca_tpu.config import (  # noqa: E402
    DataConfig,
    ModelConfig,
    TrainConfig,
    preset,
)

__version__ = "0.1.0"

__all__ = [
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "preset",
    "__version__",
]
