"""Syndrome-target BP decoding: sum-product + normalized min-sum.

Batched device replacement for the reference decoder core
(``src/qkd_ldpc_algorithm.cpp``).
"""

from qkd_ldpc_tpu.decoder.bp import (
    DecodeOptions,
    DecodeResult,
    bp_decode_batch_last,
    decode,
)
from qkd_ldpc_tpu.decoder.oracle import (
    OracleResult,
    oracle_decode,
    oracle_reconcile,
    oracle_syndrome,
)
from qkd_ldpc_tpu.decoder.blind import (
    BlindResult,
    BlindSession,
    SecureBlindResult,
    blind_reconcile,
    blind_reconcile_sim,
)
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter
from qkd_ldpc_tpu.decoder.reconcile import (
    ReconcileResult,
    apriori_llr,
    reconcile,
    reconcile_with_syndrome,
)
from qkd_ldpc_tpu.decoder.syndrome import syndrome

__all__ = [
    "DecodeOptions",
    "DecodeResult",
    "decode",
    "bp_decode_batch_last",
    "syndrome",
    "apriori_llr",
    "BlindResult",
    "BlindSession",
    "SecureBlindResult",
    "blind_reconcile",
    "blind_reconcile_sim",
    "RateAdapter",
    "reconcile",
    "reconcile_with_syndrome",
    "ReconcileResult",
    "OracleResult",
    "oracle_decode",
    "oracle_reconcile",
    "oracle_syndrome",
]
