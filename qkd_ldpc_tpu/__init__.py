"""qkd_ldpc_tpu — QKD LDPC error-reconciliation framework on JAX.

A from-scratch JAX/XLA re-design of the capability surface of the
C++ reference simulator ColdCloudd/QKD_LDPC (see SURVEY.md):

- parity-check-matrix ingest (alist + dense formats)  -> `qkd_ldpc_tpu.codes`
  (native C++ loader bindings in `qkd_ldpc_tpu.codes._native`, source in
  `native/qkd_ldpc_native.cpp`)
- key generation + exact-weight binary channel        -> `qkd_ldpc_tpu.channel`
- syndrome-target sum-product / min-sum BP decoding   -> `qkd_ldpc_tpu.decoder`
  (plain jax.numpy fused by XLA; the channel's k-th-smallest threshold is
  a Pallas-Triton kernel on the GPU, `qkd_ldpc_tpu.channel.pallas_select`)
- mesh / sharded sweeps / node-sharded decoding       -> `qkd_ldpc_tpu.parallel`
- QBER sweep planning, stats, CSV, checkpointing,
  interactive mode, console tracing                   -> `qkd_ldpc_tpu.sim`
- production serving endpoint (Alice/Bob roles)       -> `qkd_ldpc_tpu.serve`
- verification + privacy amplification (Toeplitz)     -> `qkd_ldpc_tpu.postprocess`

Unlike the reference (one process, a CPU thread pool over trials,
scalar C++ loops over graph edges), everything here is expressed as pure
functions over dense padded tensors with a leading/trailing batch ("frame")
axis, jitted through XLA, and sharded over `jax.sharding.Mesh` axes.
"""

from qkd_ldpc_tpu.config import Config, load_config
from qkd_ldpc_tpu.codes import (
    LDPCCode,
    load_code,
    make_code,
    make_qc_code,
    read_alist,
    read_dense,
)
from qkd_ldpc_tpu.decoder import (
    DecodeResult,
    decode,
    reconcile,
    syndrome,
)
from qkd_ldpc_tpu.postprocess import (
    amplified_key_bits,
    privacy_amplify,
    verification_tags,
)
from qkd_ldpc_tpu.serve import Reconciler, SecureResult, ServeResult

__version__ = "0.1.0"

__all__ = [
    "Config",
    "load_config",
    "LDPCCode",
    "read_alist",
    "read_dense",
    "load_code",
    "DecodeResult",
    "Reconciler",
    "ServeResult",
    "SecureResult",
    "make_code",
    "make_qc_code",
    "verification_tags",
    "privacy_amplify",
    "amplified_key_bits",
    "decode",
    "reconcile",
    "syndrome",
    "__version__",
]
