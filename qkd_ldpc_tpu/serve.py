"""Production serving wrapper for the reconciliation step.

The simulation stack (sim/) plays both Alice and Bob; a deployed QKD
post-processing node is ONE side of the protocol with a network boundary
in between (the reference scopes this exactly at its function boundary,
``QKD_LDPC_regular``, src/qkd_ldpc_algorithm.cpp:347-396 — see
decoder/reconcile.py).  This module packages that boundary as a
long-lived object with a serving-shaped contract:

- **One compile, any request size**: the decode program is compiled once
  for a fixed lane count; requests are padded (and chunked) to it, so a
  stream of ragged request sizes never recompiles.  QBER is a traced
  argument — channel-estimate updates don't recompile either.
- **Pipelined chunks** (round 3): all chunks of a request are dispatched
  before any is fetched — the dispatch/fetch host latency of
  chunk k+1 hides under chunk k's device compute, the same discipline
  every sim path uses (sim/runner.py).
- **Host-friendly IO**: NumPy in, NumPy out.
- **Both roles**: `syndromes()` is Alice's side (compute the syndromes
  to transmit); `reconcile()` is Bob's (correct the noisy key toward the
  received syndromes).  `leak_bits` reports the information disclosed
  per frame for the privacy-amplification budget.
- **Full post-processing chain** (round 3): `reconcile_secure()` runs
  reconcile -> verification tags -> privacy amplification in one call,
  with a per-frame leakage ledger (syndrome + tag bits) driving the
  final key length (qkd_ldpc_tpu.postprocess); `tags()` serves the
  Alice side of verification.
- **Rate adaptation**: pass ``adapter=RateAdapter(...)`` to serve an
  adapted rate over the mother code — requests then carry payload bits,
  punctured positions are decoder-recovered erasures, and the leakage
  accounting follows the adapter.  Adapters bind to the endpoint's code
  by CONTENT fingerprint (``LDPCCode.fingerprint``), not shape — a
  same-shape different-graph adapter is rejected, not silently served.
  The adapted path (LLR assembly + decode + payload gather) is one
  jitted program per endpoint: no per-chunk host-side LLR construction.

Example::

    rec = Reconciler(code, DecodeOptions(message_dtype="bfloat16"))
    rec.warmup()                        # optional: pay the compile now
    syn = rec.syndromes(alice_bits)     # Alice -> (classical channel)
    out = rec.reconcile(bob_bits, syn, qber=0.04)   # Bob
    corrected, ok = out.bits, out.syndromes_match

    # or the full chain (tag_key/pa_key are shared protocol randomness):
    a_tags = rec.tags(alice_bits, tag_key)          # Alice -> channel
    sec = rec.reconcile_secure(bob_bits, syn, qber=0.04,
                               alice_tags=a_tags,
                               tag_key=tag_key, pa_key=pa_key)
    final_key = sec.key[sec.verified]
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.decoder.bp import DecodeOptions, bp_decode_batch_last
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu.decoder.syndrome import syndrome as syndrome_fn
from qkd_ldpc_tpu.postprocess import (
    amplified_key_bits,
    privacy_amplify,
    toeplitz_hash,
)


class ServeResult(NamedTuple):
    """Host-side reconciliation outcome (NumPy)."""

    bits: np.ndarray  # [n, frame_bits] uint8 corrected key (payload
    # bits on a rate-adapted endpoint)
    iterations: np.ndarray  # [n] int32
    syndromes_match: np.ndarray  # [n] bool — verify before using the key!


class SecureResult(NamedTuple):
    """Outcome of the full post-processing chain (NumPy)."""

    key: np.ndarray  # [n, final_bits] uint8 amplified key material
    verified: np.ndarray  # [n] bool: syndromes matched AND tags matched.
    # Use key[i] ONLY where verified[i]; unverified frames are discarded
    # (their rows are hashes of unreliable bits, not secrets leaked).
    iterations: np.ndarray  # [n] int32
    syndromes_match: np.ndarray  # [n] bool (pre-verification)
    leak_bits: np.ndarray  # [n] int32 per-frame disclosure ledger
    final_bits: int  # columns of `key`


@partial(jax.jit, static_argnames=("opts",))
def _serve_step(code, bob, syn, qber, opts):
    llr = apriori_llr(bob, qber)
    z, iters, ok = bp_decode_batch_last(
        code, llr.T, syn.T.astype(jnp.int8), opts
    )
    return z.T.astype(jnp.uint8), iters, ok


@partial(jax.jit, static_argnames=("opts",))
def _serve_step_adapted(code, bob_payload, syn, qber, key_idx, short_idx,
                        short_pinned, opts):
    """Rate-adapted serve step, fully on device: assemble full-frame LLRs
    (channel LLRs at payload positions, 0 erasures at punctured, pinned
    at shortened), decode, gather the corrected payload."""
    B = bob_payload.shape[0]
    llr = jnp.zeros((B, code.n_vars), jnp.float32)
    llr = llr.at[:, key_idx].set(apriori_llr(bob_payload, qber))
    if short_idx.shape[0]:
        llr = llr.at[:, short_idx].set(short_pinned[None, :])
    z, iters, ok = bp_decode_batch_last(
        code, llr.T, syn.T.astype(jnp.int8), opts
    )
    payload = jnp.take(z.T, key_idx, axis=1).astype(jnp.uint8)
    return payload, iters, ok


@jax.jit
def _syndrome_step(code, bits):
    return syndrome_fn(code, bits)


class Reconciler:
    """Long-lived reconciliation endpoint bound to one code + options.

    ``lanes`` is the compiled batch width; requests of any size are
    padded/chunked to it.  Latency/throughput trade-off: small lanes for
    low latency, large for throughput (not measured on the card yet).
    """

    def __init__(
        self,
        code: LDPCCode,
        opts: DecodeOptions = DecodeOptions(),
        lanes: int = 128,
        adapter: RateAdapter | None = None,
        shared_seed: int = 0,
    ):
        """``adapter`` serves an adapted rate over the mother ``code``
        (decoder.rate_adapt): requests then carry PAYLOAD bits
        (``adapter.payload_bits`` per frame), punctured positions are
        erasures recovered by the decoder, and ``shared_seed`` fixes the
        shortened pattern both sides derive."""
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if adapter is not None and adapter.code is not code:
            if adapter.code.fingerprint != code.fingerprint:
                raise ValueError(
                    "adapter was built for a different code (parity-check "
                    f"fingerprint {adapter.code.fingerprint} != "
                    f"{code.fingerprint})"
                )
        self.code = code.to_device()
        self.opts = opts
        self.lanes = lanes
        self.adapter = adapter
        self.shared_seed = shared_seed
        # Chunks allowed in flight before the oldest is fetched: enough to
        # hide the dispatch/fetch host latency under device
        # compute, small enough that device memory stays constant in the
        # request size.
        self.max_inflight_chunks = 4
        if adapter is not None:
            # Device-resident endpoint constants of the adapted path.
            self._key_idx = jnp.asarray(adapter.key_idx)
            self._short_idx = jnp.asarray(adapter.short_idx)
            known = adapter.short_pattern(shared_seed)
            from qkd_ldpc_tpu.decoder.rate_adapt import _KNOWN_LLR

            self._short_pinned = jnp.where(
                known == 1, -_KNOWN_LLR, _KNOWN_LLR
            ).astype(jnp.float32)

    @property
    def frame_bits(self) -> int:
        """Bits per request frame (payload bits when rate-adapted)."""
        if self.adapter is not None:
            return self.adapter.payload_bits
        return self.code.n_vars

    @property
    def syndrome_bits(self) -> int:
        return self.code.n_checks

    @property
    def leak_bits(self) -> int:
        """Information disclosed per frame by RECONCILIATION (syndrome
        bits, net of punctured entropy when rate-adapted).  The secure
        chain adds tag bits on top (``reconcile_secure``)."""
        if self.adapter is not None:
            return self.adapter.leak_bits
        return self.code.n_checks

    def final_key_bits(self, tag_bits: int = 64,
                       security_bits: int = 100) -> int:
        """Post-amplification key length per verified frame."""
        return amplified_key_bits(
            self.frame_bits, self.leak_bits, tag_bits, security_bits
        )

    def warmup(self) -> "Reconciler":
        """Compile both directions now (first call is otherwise slow)."""
        bob = np.zeros((1, self.frame_bits), np.uint8)
        syn = self.syndromes(bob, frame_key=jax.random.PRNGKey(0))
        self.reconcile(bob, syn, qber=0.01)
        return self

    def syndromes(self, bits, frame_key=None) -> np.ndarray:
        """Alice side: syndromes [n, M] of key frames [n, frame_bits]
        (or 1-D).  Rate-adapted endpoints assemble the full mother-code
        frame first; ``frame_key`` supplies Alice's PRIVATE randomness
        for punctured positions (required when the adapter punctures)."""
        arr = np.asarray(bits, np.uint8)
        single = arr.ndim == 1
        if single:
            arr = arr[None]
        if arr.shape[-1] != self.frame_bits:
            raise ValueError(
                f"expected {self.frame_bits}-bit frames, got {arr.shape[-1]}"
            )
        if self.adapter is not None:
            if self.adapter.punct_idx.size and frame_key is None:
                raise ValueError(
                    "frame_key (Alice's private randomness for punctured "
                    "bits) is required on a punctured endpoint"
                )
            frames = self.adapter.build_frames(
                jnp.asarray(arr),
                frame_key if frame_key is not None else jax.random.PRNGKey(0),
                self.shared_seed,
            )
            out = np.asarray(_syndrome_step(self.code, frames))
        else:
            out = np.asarray(_syndrome_step(self.code, jnp.asarray(arr)))
        return out[0] if single else out

    def tags(self, bits, tag_key, tag_bits: int = 64) -> np.ndarray:
        """Verification tags over key frames (either side; Alice
        transmits hers alongside the syndromes).  ``tag_key`` is shared
        protocol randomness — fresh per exchange."""
        arr = np.asarray(bits, np.uint8)
        single = arr.ndim == 1
        if single:
            arr = arr[None]
        if arr.shape[-1] != self.frame_bits:
            raise ValueError(
                f"expected {self.frame_bits}-bit frames, got {arr.shape[-1]}"
            )
        out = np.asarray(toeplitz_hash(jnp.asarray(arr), tag_key, tag_bits))
        return out[0] if single else out

    def _dispatch(self, b: np.ndarray, s: np.ndarray, q: jax.Array):
        """One padded chunk -> unfetched device outputs."""
        if self.adapter is not None:
            return _serve_step_adapted(
                self.code, jnp.asarray(b), jnp.asarray(s), q,
                self._key_idx, self._short_idx, self._short_pinned,
                self.opts,
            )
        return _serve_step(
            self.code, jnp.asarray(b), jnp.asarray(s), q, self.opts
        )

    def reconcile(self, bob_bits, alice_syndromes, qber: float) -> ServeResult:
        """Bob side: correct noisy frames toward received syndromes.

        ``syndromes_match[i]`` False means frame i did NOT verify — it
        must be discarded (or retried at a lower rate), never used as key
        material.
        """
        bob = np.asarray(bob_bits, np.uint8)
        syn = np.asarray(alice_syndromes)
        single = bob.ndim == 1
        if single:
            bob, syn = bob[None], syn[None]
        if bob.shape[-1] != self.frame_bits:
            raise ValueError(
                f"expected {self.frame_bits}-bit frames, got {bob.shape[-1]}"
            )
        if syn.shape != (bob.shape[0], self.syndrome_bits):
            raise ValueError(
                f"expected syndromes [{bob.shape[0]}, {self.syndrome_bits}], "
                f"got {syn.shape}"
            )
        if not (0.0 < qber < 1.0):
            raise ValueError("qber must be in (0, 1)")

        n = bob.shape[0]
        bits = np.empty((n, self.frame_bits), np.uint8)
        iters = np.empty((n,), np.int32)
        ok = np.empty((n,), bool)
        q = jnp.asarray(qber, jnp.float32)

        # Keep a bounded window of chunks in flight: chunk k+1's dispatch
        # latency hides under chunk k's decode (the round-3 pipelining
        # win), but device buffers stay O(window * lanes) instead of
        # O(request) — an unbounded dispatch-all would hold every chunk's
        # inputs AND outputs live simultaneously and can OOM HBM on very
        # large requests.
        pending = []

        def _fetch_one():
            off, chunk, (z, it, okd) = pending.pop(0)
            bits[off:off + chunk] = np.asarray(z)[:chunk]
            iters[off:off + chunk] = np.asarray(it)[:chunk]
            ok[off:off + chunk] = np.asarray(okd)[:chunk]

        for off in range(0, n, self.lanes):
            chunk = min(self.lanes, n - off)
            pad = self.lanes - chunk
            b = np.pad(bob[off:off + chunk], ((0, pad), (0, 0)))
            s = np.pad(syn[off:off + chunk], ((0, pad), (0, 0)))
            pending.append((off, chunk, self._dispatch(b, s, q)))
            if len(pending) >= self.max_inflight_chunks:
                _fetch_one()
        while pending:
            _fetch_one()
        res = ServeResult(bits=bits, iterations=iters, syndromes_match=ok)
        if single:
            res = ServeResult(res.bits[0], res.iterations[0],
                              res.syndromes_match[0])
        return res

    def reconcile_secure(
        self,
        bob_bits,
        alice_syndromes,
        qber: float,
        alice_tags,
        tag_key,
        pa_key,
        tag_bits: int = 64,
        security_bits: int = 100,
    ) -> SecureResult:
        """The full Bob-side post-processing chain in one call:
        reconcile -> verification tags (compare against Alice's) ->
        privacy amplification, with the per-frame leakage ledger
        (syndrome disclosure + tag bits) setting the final key length.

        ``alice_tags`` [n, tag_bits] arrive over the classical channel;
        ``tag_key``/``pa_key`` are the shared hash seeds (fresh per
        exchange).  Returns amplified key material; use row i only where
        ``verified[i]``.
        """
        res = self.reconcile(bob_bits, alice_syndromes, qber)
        single = np.asarray(bob_bits).ndim == 1
        bits = np.atleast_2d(res.bits)
        syn_ok = np.atleast_1d(res.syndromes_match)
        a_tags = np.atleast_2d(np.asarray(alice_tags, np.uint8))
        n = bits.shape[0]
        if a_tags.shape != (n, tag_bits):
            raise ValueError(
                f"expected alice_tags [{n}, {tag_bits}], got {a_tags.shape}"
            )

        bob_tags = np.asarray(
            toeplitz_hash(jnp.asarray(bits), tag_key, tag_bits)
        )
        verified = syn_ok & (bob_tags == a_tags).all(axis=-1)

        final_bits = self.final_key_bits(tag_bits, security_bits)
        key = np.asarray(
            privacy_amplify(jnp.asarray(bits), pa_key, final_bits)
        )
        leak = np.full((n,), self.leak_bits + tag_bits, np.int32)
        out = SecureResult(
            key=key, verified=verified,
            iterations=np.atleast_1d(res.iterations),
            syndromes_match=syn_ok, leak_bits=leak, final_bits=final_bits,
        )
        if single:
            out = SecureResult(out.key[0], out.verified[0],
                               out.iterations[0], out.syndromes_match[0],
                               out.leak_bits[0], final_bits)
        return out
