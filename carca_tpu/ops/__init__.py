"""Kernels and table layouts for the hot paths.

* :mod:`carca_tpu.ops.retrieval_topk` — exact full-catalog top-k by a
  group-max tournament whose catalog pass is a Pallas kernel (Triton route
  on the GPU, interpret mode on the CPU), with ``groupmax_plain`` as its
  plain-jnp reference.
* :mod:`carca_tpu.ops.packed_table` — lane-packed embedding tables.
"""

from carca_tpu.ops.retrieval_topk import (  # noqa: F401
    QuantizedIndex,
    catalog_topk,
    dequantize_index,
    quantize_index,
)
