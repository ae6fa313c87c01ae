"""nextgenmap_tpu — a JAX short-read mapper.

A from-scratch reimplementation of the capabilities of Cibiv/NextGenMap
(SURVEY.md) designed for accelerators:

- k-mer index held as CSR arrays in device memory, queried with vectorized gathers
  (reference: CompactPrefixTable / "CSSearchTable", ref:src/CompactPrefixTable.cpp)
- candidate search as a jitted batched sort/segment-count over diagonals
  (reference: CS task, ref:src/CS.cpp)
- banded Smith-Waterman score + traceback as JAX lax.scan kernels
  (reference: SWOcl score/cigar OpenCL kernels, ref:src/SWOcl*.cpp)
- data parallelism over reads via jax.sharding / shard_map meshes instead of
  the reference's pthread pipeline (ref:src/NGM.cpp, ref:src/NGMThreads.cpp)
"""

__version__ = "0.1.0"

from nextgenmap_tpu.config import NgmConfig  # noqa: F401
